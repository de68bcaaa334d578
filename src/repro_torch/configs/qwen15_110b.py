"""Assigned architecture config: QWEN15_110B (see archs.py for the source)."""
from repro_torch.configs.archs import QWEN15_110B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
