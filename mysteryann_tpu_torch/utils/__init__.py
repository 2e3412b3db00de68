from mysteryann_tpu_torch.utils.params import BuildConfig, SearchConfig, Parameters  # noqa: F401
from mysteryann_tpu_torch.utils.timers import Timer  # noqa: F401
