from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import forward, lm_loss  # noqa: F401
from repro_torch.models.params import (  # noqa: F401
    count_params,
    init_params,
    param_defs,
    param_shapes,
)
