"""The training entry point: ``repro_torch.train.fit`` (one device)."""
from .driver import fit  # noqa: F401
