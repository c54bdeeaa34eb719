"""Test-support utilities shipped with the port (no external deps): a copy
of ``repro/testing``."""
from repro_torch.testing import proptest  # noqa: F401

__all__ = ["proptest"]
