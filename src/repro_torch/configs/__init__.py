"""Architecture configs of the port (a copy of ``repro.configs``, which is
plain data).  Importing the package registers every arch."""
from repro_torch.configs import base
from repro_torch.configs import (nemotron_4_340b, llama3_405b,
                                 qwen2_5_32b, qwen1_5_4b, qwen2_vl_72b,
                                 rwkv6_3b, granite_moe_3b_a800m,
                                 deepseek_v2_236b, zamba2_7b, hubert_xlarge)
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig, get,
                                      names)

# CLI alias map: --arch <id> uses the published names with dashes/dots
ALIASES = {
    "nemotron-4-340b": "nemotron-4-340b",
    "llama3-405b": "llama3-405b",
    "qwen2.5-32b": "qwen2.5-32b",
    "qwen1.5-4b": "qwen1.5-4b",
    "qwen2-vl-72b": "qwen2-vl-72b",
    "rwkv6-3b": "rwkv6-3b",
    "granite-moe-3b-a800m": "granite-moe-3b-a800m",
    "deepseek-v2-236b": "deepseek-v2-236b",
    "zamba2-7b": "zamba2-7b",
    "hubert-xlarge": "hubert-xlarge",
}
