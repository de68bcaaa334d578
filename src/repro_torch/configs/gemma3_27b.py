"""Assigned architecture config: GEMMA3_27B (see archs.py for the source)."""
from repro_torch.configs.archs import GEMMA3_27B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
