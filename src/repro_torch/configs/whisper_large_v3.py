"""Assigned architecture config: WHISPER_LARGE_V3 (see archs.py for the source)."""
from repro_torch.configs.archs import WHISPER_LARGE_V3 as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
