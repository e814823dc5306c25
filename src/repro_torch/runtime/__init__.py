from repro_torch.runtime.ft import FTConfig, TrainerLoop  # noqa: F401
from repro_torch.runtime.straggler import StragglerPolicy  # noqa: F401
