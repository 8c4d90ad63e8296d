from .logging import get_logger, log_message  # noqa: F401
from .mt19937 import MT19937, hash_family_seeds  # noqa: F401
