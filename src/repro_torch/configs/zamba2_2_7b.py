"""Config module for --arch zamba2-2.7b (see registry.py for the entry)."""
from .registry import ZAMBA2_2P7B as CONFIG

CONFIG_ID = 'zamba2-2.7b'
