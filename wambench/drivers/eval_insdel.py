"""Evaluation of explanations: one caller takes batches back to back
through `wam_tpu_torch.Eval2DWAM`: the explainer (WAM-2D SmoothGrad with
streamed noise) once a batch (`precompute`), then insertion and deletion,
each ending in the package's one result fetch.

Inputs, from the seed: each call's own batch of images with labels, made
on the device from (seed, call) (as `offline_attr` with ``pool`` null), and
one noise seed a call for the explainer. Each call takes its explanation
to the host with its scores, so the window holds nothing on the device
from one call to the next. The check recomputes sampled calls in two
stages, since the masks follow the explanation's ranking, which rounding
reorders: the explanation against the reference's SmoothGrad (with the
package's documented streamed draws), and the insertion and deletion
curves and AUCs that the reference computes from the package's own
explanation of that call, which it reads only to judge the curves.
"""

from __future__ import annotations

import numpy as np

from wambench import common, compare, roofline
from wambench.drivers import base
from wambench.drivers.offline_attr import COLLAPSE_BELOW, FILT_LEN
from wambench.reference import insdel as ref_insdel
from wambench.reference import wam as ref_wam


def streamed_noise(seed: int, n: int, shape, device):
    """The explainer's streamed SmoothGrad draws as the package documents
    them: sample i from a generator on the device seeded with the first
    64-bit word (top bit cleared) of numpy's SeedSequence([seed, i])."""
    import torch

    out = []
    for i in range(n):
        s = int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1, np.uint64)[0])
        g = torch.Generator(device=device).manual_seed(s & (2**63 - 1))
        out.append(torch.randn(tuple(shape), generator=g, device=device))
    return torch.stack(out)


class Driver(base.Driver):
    E2E = "evaluated_images_per_s"
    # the per-layer metrics read the card and the package's spans; recording
    # the host's operators slows the fan's dispatch, which paces the card,
    # enough to idle it (41-43% of a profiled stretch against ~5% unprofiled)
    TRACE_HOST_OPS = False

    def __init__(self, cell):
        super().__init__(cell)
        self.B = self.t["batch"]

    def setup_inputs(self):
        cfg = self.cfg
        self.shape = (self.B, cfg["in_channels"], self.side, cfg["num_classes"])

    def batch(self, i: int):
        """Call i's images and labels on the device, and the labels as a list."""
        x, y = common.image_batch(self.cell.seed, i, *self.shape, self.device)
        return x, y, y.tolist()

    def noise_seed(self, i: int) -> int:
        return common.sub_seed(self.cell.seed, 3, i) & 0xFFFFFFFF

    def setup_program(self):
        import wam_tpu_torch

        fn = common.port_model(self.cell)
        t = self.t
        explainer = wam_tpu_torch.WaveletAttribution2D(
            fn, wavelet=t["wavelet"], J=t["levels"], mode=t["mode"], method="smooth",
            n_samples=t["explain_samples"], stdev_spread=t["stdev_spread"],
            sample_batch_size=t["explain_sample_batch_size"], stream_noise=True,
            device=self.device, impl=t["impl"])
        self.ev = wam_tpu_torch.Eval2DWAM(fn, explainer, wavelet=t["wavelet"], J=t["levels"],
                                          mode=t["mode"], batch_size=t["rows_per_model_call"],
                                          precision="f32", device=self.device, impl=t["impl"])

    def program(self):
        ev, n = self.ev, self.t["n_iter"]

        def call(i):
            x, _, y = self.batch(i)
            ev.reset()  # a fresh batch: its own explanation
            ev.explainer.random_seed = self.noise_seed(i)
            expl = ev.precompute(x, y)
            ins = ev.insertion(x, y, n_iter=n)
            dele = ev.deletion(x, y, n_iter=n)
            return {"expl": expl.cpu(), "ins": np.asarray(ins), "ins_curves": np.stack(ev.insertion_curves),
                    "del": np.asarray(dele), "del_curves": np.stack(ev.deletion_curves)}

        return call

    def free_program(self):
        del self.ev

    # -- the reference and the control ----------------------------------------------

    def setup_reference(self, dtype):
        self.ref_model = common.reference_model(self.cell, dtype)
        self.ref_dtype = dtype

    def _explain(self, i: int):
        t = self.t
        x, y, _ = self.batch(i)
        noise = streamed_noise(self.noise_seed(i), t["explain_samples"], x.shape, self.device)
        return ref_wam.smoothgrad(self.ref_model, x, y, noise, name=t["wavelet"],
                                  levels=t["levels"], spread=t["stdev_spread"],
                                  chunk=t["explain_sample_batch_size"] or t["explain_samples"],
                                  dtype=self.ref_dtype)

    def _curves(self, i: int, expl):
        import torch

        t = self.t
        x, _, y = self.batch(i)
        out = {"ins": [], "ins_curves": [], "del": [], "del_curves": []}
        with torch.no_grad():
            for b in range(self.B):
                ins, dele = ref_insdel.masks(expl[b].to(self.device), t["n_iter"])
                for key, fam in (("ins", ins), ("del", dele)):
                    c = ref_insdel.curve(self.ref_model, x[b], y[b], fam, name=t["wavelet"],
                                         levels=t["levels"], dtype=self.ref_dtype)
                    out[key + "_curves"].append(c.cpu().numpy())
                    out[key].append(float(ref_insdel.auc(c)))
        return {k: np.asarray(v) for k, v in out.items()}

    def reference(self, i: int, outputs=None):
        """The reference's explanation of call i, and its curves from the
        package's explanation of that call, ``outputs[i]["expl"]`` (from
        its own when ``outputs`` is None)."""
        expl = self._explain(i).cpu()
        res = self._curves(i, expl if outputs is None else outputs[i]["expl"])
        res["expl"] = expl
        return res

    def control(self):
        def call(i):
            return self.reference(i)

        return call

    @staticmethod
    def compare(got, want) -> dict:
        """The explanation (the batch's relative L2 distance and the largest
        1 - Spearman over its images), the curves (largest |difference| over each curve's maximum) and the
        AUCs (largest |difference|)."""
        curve = auc = 0.0
        for key in ("ins", "del"):
            g, w = got[key + "_curves"], want[key + "_curves"]
            scale = np.maximum(np.abs(w).max(axis=1), 1e-30)
            curve = max(curve, float((np.abs(g - w).max(axis=1) / scale).max()))
            auc = max(auc, float(np.abs(got[key] - want[key]).max()))
        return {"expl_batch_rel_err": compare.batch_rel_err(got["expl"], want["expl"]),
                "expl_rank_err": compare.rank_err(got["expl"], want["expl"]),
                "curve_rel_err": curve, "auc_abs_err": auc}

    def facts(self) -> dict:
        t, cfg = self.t, self.cfg
        fwd, fwd_bwd = self.row_flops()
        rows = 2 * (t["n_iter"] + 1)
        L = FILT_LEN[t["wavelet"]]
        C = cfg["in_channels"]
        J = t["levels"]
        n = t["explain_samples"]
        fam = t["n_iter"] + 1
        k1 = (roofline.k1_bound_s(n * self.B * C, self.side, self.side, L, J)
              + 2 * self.B * roofline.k1_bound_s(C, self.side, self.side, L, J))
        k3 = (roofline.k3_bound_s(n * self.B * C, self.side, self.side, L, J, COLLAPSE_BELOW, True)
              + 2 * self.B * roofline.k3_bound_s(fam * C, self.side, self.side, L, J,
                                                 COLLAPSE_BELOW, False))
        return {"model_flops_per_item": n * fwd_bwd + rows * fwd,
                "k1_bound_s_per_call": k1, "k3_bound_s_per_call": k3,
                "items_per_call": self.B}
