from kmbart_tpu_torch.data.tokenization import ConditionTokenizer  # noqa: F401
from kmbart_tpu_torch.data.collation import Collator  # noqa: F401
