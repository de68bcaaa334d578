"""Assigned architecture config: MAMBA2_130M (see archs.py for the source)."""
from repro_torch.configs.archs import MAMBA2_130M as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
