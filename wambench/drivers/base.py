"""What every driver offers `wambench.run` and `wambench.control`, with the
defaults of a closed loop: warm-up calls at indices the window never
reaches, the window as `loop.closed_loop` over `program()`, the checked
calls drawn from the seed, the control on the first calls, and the rate of
items over the window's seconds. A driver overrides what its traffic does
otherwise (the open loop: its own warm-up, window, samples and control
requests)."""

from __future__ import annotations

import numpy as np

from wambench import common
from wambench.loop import closed_loop

WARM_INDEX = 10**6  # warm-up calls use call indices the window never reaches


class Driver:
    E2E: str = ""  # the end-to-end metric the driver's window gives
    # whether a traced stretch records the host's operators (the ranges that
    # `wavelet_share.attr` reads) or, cheaper for the host, the card alone
    TRACE_HOST_OPS = True

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.t = cell.traffic
        self.device = cell.device
        self.side = self.cfg["image_size"]

    # -- the window -----------------------------------------------------------------

    def warmup(self):
        self._call = self.program()
        for k in range(self.t["warmup_calls"]):
            self._call(WARM_INDEX + k)

    def window(self, seconds: float, trace: bool, obs, launches):
        call, self._call = self._call, None
        return closed_loop(call, self.facts()["items_per_call"], seconds, trace,
                           self.t["trace_calls"], spans=obs if trace else None,
                           launches=launches, device_only=not self.TRACE_HOST_OPS)

    def e2e(self, window) -> dict:
        return {self.E2E: window.items / window.seconds}

    # -- the check ------------------------------------------------------------------

    def samples(self, window) -> list[int]:
        """The calls to check, drawn from the seed."""
        rng = np.random.default_rng(common.sub_seed(self.cell.seed, 4))
        k = min(self.t["check_calls"], window.calls)
        return sorted(int(i) for i in rng.choice(window.calls, size=k, replace=False))

    def control_indices(self, k: int) -> list[int]:
        return list(range(k))

    # -- what the per-layer metrics read ----------------------------------------------

    def row_flops(self) -> tuple[float, float]:
        """Model FLOPs of one image row: its forward, and its forward plus
        the input-gradient backward (2 x the multiply-adds of every
        convolution, dense layer and attention product; the weights are
        frozen, so no weight gradient). The backward of an attention
        product takes two products, of a convolution or a dense layer one."""
        m = self.cell.family.macs(self.cfg, (self.side, self.side))
        fwd = m["conv"] + m["linear"] + m["attention"]
        bwd = m["conv"] + m["linear"] + 2 * m["attention"]
        return 2.0 * fwd, 2.0 * (fwd + bwd)
