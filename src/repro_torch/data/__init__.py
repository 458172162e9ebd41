from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       PrefetchIterator)
