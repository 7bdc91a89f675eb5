"""Data: on-device preprocessing."""
