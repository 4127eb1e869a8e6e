"""Offline attribution: one caller explains batches back to back with
`wam_tpu_torch.WaveletAttribution2D` (SmoothGrad or Integrated Gradients)
and takes each batch's mosaics to the host.

Inputs, from the seed: image batches with labels made on the device, and
for SmoothGrad one noise seed a call (the explainer's ``random_seed``: its
draws are a generator on the device seeded with it, as the package
documents). With ``pool`` a number, that many batches are made in set-up
and rotated through the calls (SmoothGrad: each call's noisy rows are its
own all the same); with ``pool`` null each call makes a batch of its own
from (seed, call), so no two calls of a window repeat an input (Integrated
Gradients is deterministic: a rotated pool would repeat whole calls).

The check recomputes sampled calls with the plain reference
(`wambench.reference.wam`) in float32 with TF32 off and compares each
image's mosaic.
"""

from __future__ import annotations

from wambench import common, compare, roofline
from wambench.drivers import base
from wambench.reference import wam as ref_wam

COLLAPSE_BELOW = 128  # the package's K3 crossover (transform.SYNTH_COLLAPSE)
FILT_LEN = {"haar": 2, "db4": 8}


class Driver(base.Driver):
    E2E = "attributions_per_s"

    def __init__(self, cell):
        super().__init__(cell)
        self.smooth = self.t["method"] == "smooth"
        self.B = self.t["batch"]

    # -- inputs ---------------------------------------------------------------------

    def setup_inputs(self):
        cfg = self.cfg
        self.shape = (self.B, cfg["in_channels"], self.side, cfg["num_classes"])
        if self.t["pool"]:
            self.x, self.y = common.image_pool(self.cell.seed, self.t["pool"], *self.shape,
                                               self.device)

    def batch(self, i: int):
        if not self.t["pool"]:
            return common.image_batch(self.cell.seed, i, *self.shape, self.device)
        k = i % self.t["pool"]
        return self.x[k], self.y[k]

    def noise_seed(self, i: int) -> int:
        return common.sub_seed(self.cell.seed, 3, i)

    # -- the program ----------------------------------------------------------------

    def setup_program(self):
        import wam_tpu_torch

        fn = common.port_model(self.cell)
        t = self.t
        kw = dict(n_samples=t["n_samples"], sample_batch_size=t["sample_batch_size"])
        if self.smooth:
            kw.update(stdev_spread=t["stdev_spread"], stream_noise=False)
        self.wam = wam_tpu_torch.WaveletAttribution2D(
            fn, wavelet=t["wavelet"], J=t["levels"], mode=t["mode"], method=t["method"],
            device=self.device, impl=t["impl"], **kw)

    def program(self):
        def call(i):
            x, y = self.batch(i)
            if self.smooth:
                self.wam.random_seed = self.noise_seed(i)
            return self.wam(x, y).cpu()

        return call

    def free_program(self):
        del self.wam

    # -- the reference and the control ----------------------------------------------

    def setup_reference(self, dtype):
        self.ref_model = common.reference_model(self.cell, dtype)
        self.ref_dtype = dtype

    def reference(self, i: int, outputs=None):
        """The reference's mosaics of call i (the package's ``outputs`` are
        not read)."""
        import torch

        x, y = self.batch(i)
        t = self.t
        chunk = t["sample_batch_size"] or t["n_samples"]
        if self.smooth:
            g = torch.Generator(device=self.device).manual_seed(self.noise_seed(i))
            noise = torch.randn((t["n_samples"],) + tuple(x.shape), generator=g,
                                device=self.device)
            out = ref_wam.smoothgrad(self.ref_model, x, y, noise, name=t["wavelet"],
                                     levels=t["levels"], spread=t["stdev_spread"], chunk=chunk,
                                     dtype=self.ref_dtype)
        else:
            out = ref_wam.integrated(self.ref_model, x, y, name=t["wavelet"], levels=t["levels"],
                                     steps=t["n_samples"], chunk=chunk, dtype=self.ref_dtype)
        return out.cpu()

    def control(self):
        return self.reference

    @staticmethod
    def compare(got, want) -> dict:
        """Each image's mosaic against the reference's: the largest relative
        L2 distance and the largest 1 - Spearman over the images."""
        return {"mosaic_rel_err": compare.rel_err(got, want),
                "mosaic_rank_err": compare.rank_err(got, want)}

    # -- what the per-layer metrics read ----------------------------------------------

    def facts(self) -> dict:
        """Model FLOPs an attribution and the transform kernels' least time
        a call, from the shapes."""
        t, cfg = self.t, self.cfg
        n = t["n_samples"]
        L = FILT_LEN[t["wavelet"]]
        C = cfg["in_channels"]
        chunk = t["sample_batch_size"] or n
        sizes = [min(chunk, n - i) for i in range(0, n, chunk)]
        J = t["levels"]
        if self.smooth:  # every chunk decomposes its noisy rows
            k1 = sum(roofline.k1_bound_s(s * self.B * C, self.side, self.side, L, J) for s in sizes)
        else:  # the input is decomposed once
            k1 = roofline.k1_bound_s(self.B * C, self.side, self.side, L, J)
        k3 = sum(roofline.k3_bound_s(s * self.B * C, self.side, self.side, L, J, COLLAPSE_BELOW,
                                     True) for s in sizes)
        return {"model_flops_per_item": n * self.row_flops()[1], "k1_bound_s_per_call": k1,
                "k3_bound_s_per_call": k3, "items_per_call": self.B}

