"""Activity tokenizer: dictionary encoding at the host boundary.

Maps activity ids of an EventFrame into a model vocabulary with reserved
specials. This is where the paper's "dictionary-encoded string columns" meet
the LM side of the framework: traces become token sequences for
next-activity prediction.
"""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
NUM_SPECIALS = 3


class ActivityTokenizer:
    def __init__(self, activity_table: list[str]):
        self.table = list(activity_table)

    @property
    def vocab_size(self) -> int:
        return len(self.table) + NUM_SPECIALS

    def encode(self, activity_ids: np.ndarray) -> np.ndarray:
        return activity_ids.astype(np.int32) + NUM_SPECIALS

    def decode(self, tokens: np.ndarray) -> list[str]:
        """Names of ``tokens``; an id past the activity table (a model's
        vocabulary is larger than the table, and an untrained model emits
        such ids) is ``"<unk>"``, where the JAX package raises IndexError."""
        out = []
        for t in np.asarray(tokens).ravel():
            if t >= self.vocab_size:
                out.append("<unk>")
            elif t >= NUM_SPECIALS:
                out.append(self.table[int(t) - NUM_SPECIALS])
            else:
                out.append(["<pad>", "<bos>", "<eos>"][int(t)])
        return out
