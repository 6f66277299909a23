"""Config module for --arch whisper-medium (see registry.py for the entry)."""
from .registry import WHISPER_MEDIUM as CONFIG

CONFIG_ID = 'whisper-medium'
