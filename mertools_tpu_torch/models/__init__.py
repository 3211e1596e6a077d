from .base import get_model  # noqa: F401

# importing registers each model under its reference name; the rest of the
# reference zoo (MERBench/toolkit/models/__init__.py:18-46) is ROADMAP A7
from . import attention  # noqa: F401
