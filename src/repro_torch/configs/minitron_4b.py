"""Config module for --arch minitron-4b (see registry.py for the entry)."""
from .registry import MINITRON_4B as CONFIG

CONFIG_ID = 'minitron-4b'
