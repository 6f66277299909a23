"""Config module for --arch xlstm-1.3b (see registry.py for the entry)."""
from .registry import XLSTM_1P3B as CONFIG

CONFIG_ID = 'xlstm-1.3b'
