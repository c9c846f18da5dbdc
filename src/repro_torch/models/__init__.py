"""The EventLM model stack (dense family): configuration, parameter
creation, layers, attention, transformer blocks and the serving entry
points ``forward`` / ``prefill`` / ``decode_step``."""
