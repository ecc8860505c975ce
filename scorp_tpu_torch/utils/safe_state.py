"""Deterministic start and timestamped stdout, port of
`scorp_tpu.utils.safe_state` (the reference's general_utils.safe_state):
wraps stdout so that each line ends with a timestamp, seeds Python's,
numpy's and torch's generators, and returns a seeded `torch.Generator`
where the JAX package returns a PRNGKey. Host code: the generator is a CPU
one (torch.manual_seed also seeds every CUDA device's default generator).
"""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStdout:
    def __init__(self, old, silent: bool):
        self.old = old
        self.silent = silent

    def write(self, x: str):
        if self.silent:
            return
        if x.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            self.old.write(x.replace("\n", f" [{stamp}]\n"))
        else:
            self.old.write(x)

    def flush(self):
        self.old.flush()


def safe_state(silent: bool = False, seed: int = 0) -> torch.Generator:
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen
