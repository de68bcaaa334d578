"""Assigned architecture config: GEMMA2_27B (see archs.py for the source)."""
from repro_torch.configs.archs import GEMMA2_27B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
