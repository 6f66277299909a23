"""Config module for --arch olmoe-1b-7b (see registry.py for the entry)."""
from .registry import OLMOE_1B_7B as CONFIG

CONFIG_ID = 'olmoe-1b-7b'
