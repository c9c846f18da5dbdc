"""Training runtime of the dense family: AdamW (``optimizer``), the train
step (``trainstep``), checkpoints in the JAX package's format
(``checkpoint``), fault tolerance (``ft``) and int8 gradient compression
over the single-controller mesh (``compression``)."""
