"""f-BRS interactive click segmentation (the reference GUI's click backend,
``XMem/inference/interact/fbrs/``) in PyTorch."""

from d3fields_tpu_torch.models.fbrs.hrnet import HrnetConfig  # noqa: F401
from d3fields_tpu_torch.models.fbrs.model import (  # noqa: F401
    FbrsConfig, FbrsModel, detect_config, init_params, load_jax_params,
)
