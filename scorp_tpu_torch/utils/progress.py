"""Training progress meter: tqdm bar with EMA loss / point-count postfix
(the reference trainer's UX) plus step timing; the port's copy of
`scorp_tpu.utils.progress`."""

from __future__ import annotations

import time


class ProgressMeter:
    def __init__(self, total: int, disable: bool = False, update_every: int = 10):
        self.ema_loss = 0.0
        self.ema_depth = 0.0
        self.update_every = update_every
        self.last_time = time.time()
        self.disable = disable
        try:
            from tqdm import tqdm

            self.bar = tqdm(range(total), desc="Training progress", disable=disable)
        except ImportError:
            self.bar = None

    def update(self, iteration: int, metrics):
        if iteration % self.update_every != 0:
            return
        # one device sync per update_every iterations, not per step
        self.ema_loss = 0.4 * float(metrics.loss) + 0.6 * self.ema_loss
        self.ema_depth = 0.4 * float(metrics.depth_loss) + 0.6 * self.ema_depth
        now = time.time()
        its = self.update_every / max(now - self.last_time, 1e-9)
        self.last_time = now
        if self.bar is not None:
            self.bar.set_postfix(
                {
                    "Loss": f"{self.ema_loss:.5f}",
                    "depth": f"{self.ema_depth:.5f}",
                    "Points": int(metrics.num_alive),
                    "it/s": f"{its:.1f}",
                }
            )
            self.bar.update(self.update_every)

    def close(self):
        if self.bar is not None:
            self.bar.close()
