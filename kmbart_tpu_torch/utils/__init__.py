from kmbart_tpu_torch.utils.task import TaskType  # noqa: F401
from kmbart_tpu_torch.utils.logger import Logger  # noqa: F401
