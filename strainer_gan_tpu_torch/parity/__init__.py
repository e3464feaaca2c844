from . import oracle  # noqa: F401
from .agreement import agreement_report  # noqa: F401
from .oracle import mask_agreement  # noqa: F401
