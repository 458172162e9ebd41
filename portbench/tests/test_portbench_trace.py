"""The trace reduction and the per-layer readers on a synthetic trace."""
import pytest

from portbench.tests.smoke import CELLS
from portbench.harness import cellrun, spec, trace
from portbench.harness.peaks import PEAKS


def Ev(name, a, b, device, thread=1):
    return trace.Event(name, device, a, b, 0 if device else thread)


def _events():
    events = [Ev(trace.WINDOW, 0.0, 1000.0, False),
              Ev(trace.STEP, 0.0, 900.0, False),
              Ev("aten::mm", 100.0, 110.0, False),
              Ev("cudaLaunchKernel", 960.0, 990.0, False),
              Ev("other thread's op", 0.0, 1000.0, False, thread=2),
              Ev("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 0.0, 300.0,
                 True),
              Ev("void (anonymous namespace)::fa_forward_tc<64>(int)",
                 300.0, 400.0, True),
              Ev("void at::native::vectorized_elementwise_kernel<8>",
                 350.0, 600.0, True),
              Ev("Command Buffer Full", 600.0, 700.0, True),
              Ev("void at::native::elementwise_kernel<128, 4>", 920.0,
                 940.0, True),
              Ev("void at::native::elementwise_kernel<128, 4>", 1000.0,
                 1200.0, True),
              Ev("void at::native::elementwise_kernel<128, 4>", 2000.0,
                 2100.0, True)]
    ann = Ev(trace.STEP, 0.0, 900.0, True)
    ann.annotation = True
    return events + [ann]


def test_reduce_counts_device_work_in_the_window():
    s = trace.reduce_events(_events(), 2, {"flash_attention": {"fa_forward_tc"},
                                  "rwkv_wkv": {"wkv6_forward"}})
    assert s.window_s == pytest.approx(1e-3)
    # busy: [0, 600] and [920, 940] (the kernel at 1000 starts after the
    # window)
    assert s.busy_s == pytest.approx(620e-6)
    assert s.launches("flash_attention") == (pytest.approx(100e-6), 1)
    assert s.launches("rwkv_wkv") == (0, 0)
    assert "Command Buffer Full" not in s.kernels
    assert sum(n for _, n in s.kernels.values()) == 4
    # the idle gaps [600, 920] and [940, 1000] are named by the host op
    # open at their middle: the step's range, and a launch outside any op
    assert s.gaps == {trace.STEP: pytest.approx(320e-6),
                      "cudaLaunchKernel": pytest.approx(60e-6)}
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("nvjet")


def test_readers_on_the_synthetic_trace():
    s = trace.reduce_events(_events(), 2, {"flash_attention": {"fa_forward_tc"}})
    cell = spec.load_cell("granite-moe-3b-a800m.score-128x2048")
    view = cellrun.RunView(trace=s, config=cell.config, traffic=cell.traffic,
                           peaks=PEAKS["H100"], reference=cell.reference)
    got = {n: m.read(view) for n, m in cell.per_layer.items()}
    assert got["matmul.ms_per_step"] == pytest.approx(0.15)
    # the elementwise kernels in the window: 250 µs + 20 µs, two steps
    assert got["eager.ms_per_step"] == pytest.approx(0.135)
    assert got["device.idle_pct"] == pytest.approx(38.0)
    tr = cell.traffic
    fa = cell.per_layer["flash_attention_roofline"]
    least = fa.bound(tr["batch"], tr["prompt_len"], 24, 8, 64,
                     PEAKS["H100"])[0]
    assert got["flash_attention_roofline"] == pytest.approx(
        100 * least / 100e-6)
    flops = cell.reference.step_flops(cell.config, tr["batch"],
                                      tr["prompt_len"])
    assert got["prefill_mfu"] == pytest.approx(
        100 * flops / (0.5e-3 * 989e12))


def test_the_kept_copies_are_left_out():
    """Device operations launched inside a ``portbench.sample`` range (the
    harness's copies of the requests it keeps) count nowhere; one launched
    under the step with the same name still counts."""
    copy = "void at::native::elementwise_kernel<128, 4>"
    events = [Ev(trace.WINDOW, 0.0, 1000.0, False),
              Ev(trace.STEP, 0.0, 500.0, False),
              Ev("cudaLaunchKernel", 10.0, 20.0, False),
              Ev(trace.SAMPLE, 500.0, 600.0, False),
              Ev("cudaLaunchKernel", 510.0, 520.0, False),
              Ev("cudaMemcpyAsync", 530.0, 540.0, False),
              Ev(copy, 30.0, 130.0, True),
              Ev(copy, 525.0, 725.0, True),
              Ev("Memcpy DtoD (Device -> Device)", 730.0, 780.0, True)]
    for e, c in zip(events[2:], (1, 0, 2, 3, 1, 2, 3)):
        e.corr = c
    s = trace.reduce_events(events, 1, {})
    assert s.kernels == {copy: [pytest.approx(100e-6), 1]}
    assert s.busy_s == pytest.approx(100e-6)
    assert (s.sample_ops, s.sample_s) == (2, pytest.approx(250e-6))


def test_readers_return_nothing_without_device_time():
    s = trace.TraceSummary(window_s=1.0, busy_s=0.0, steps=3, kernels={},
                           gaps={}, port={})
    for name in CELLS:
        cell = spec.load_cell(name)
        view = cellrun.RunView(trace=s, config=cell.config,
                               traffic=cell.traffic, peaks=PEAKS["H100"],
                               reference=cell.reference)
        assert all(m.read(view) is None for m in cell.per_layer.values())


def test_port_kernel_names_come_from_the_sources():
    names = trace.port_kernels()
    assert {"fa_forward_tc", "fa_forward"} <= names["flash_attention"]
    assert names["rwkv_wkv"] == {"wkv6_forward"}
