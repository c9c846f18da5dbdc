"""Synthetic event logs, the activity tokenizer and the LM token pipeline."""
