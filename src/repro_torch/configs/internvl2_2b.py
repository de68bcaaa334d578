"""Assigned architecture config: INTERNVL2_2B (see archs.py for the source)."""
from repro_torch.configs.archs import INTERNVL2_2B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
