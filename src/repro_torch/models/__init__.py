"""Architecture substrate of the port: the JAX package's architectures as
functional PyTorch models (``src/repro/models/__init__.py``)."""

from repro_torch.models.model import Model, token_cross_entropy
from repro_torch.models import attention, common, moe, ssm, transformer

__all__ = ["Model", "attention", "common", "moe", "ssm", "token_cross_entropy", "transformer"]
