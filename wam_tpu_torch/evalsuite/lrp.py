"""Layer-wise Relevance Propagation for the ResNet zoo (PyTorch port of
`wam_tpu.evalsuite.lrp`): zennit's ``EpsilonPlusFlat`` composite with a
ResNet canonizer, as the reference's ``lrp`` registry entry runs it.

- canonizer: every BatchNorm folded into its conv (`models.resnet._fold_bn`
  on a float32 copy; the caller's module is never touched), so every linear
  site is one conv plus the BatchNorm's remaining shift as its bias;
- Flat on the 7x7 stem conv (modified input and weight 1), ZPlus on every
  other conv (z+ = conv(x+, W+) + conv(x-, W-) + max(b, 0): the clamped
  bias enters z but takes no relevance), ε on the dense head;
- the max-pool routes relevance to each window's first maximum (its exact
  vector-Jacobian product, the reference's tie rule too; a window tied
  after the stem ReLU is all zeros, and zeros carry no relevance: ZPlus
  multiplies relevance by the input), the global mean spreads it in
  proportion, a residual add splits it in proportion to each branch's
  value, and a ReLU passes it through.

Each step is the generic rule R_in = x ⊙ ρ(W)ᵀ[R / (z_ρ + ε sign z_ρ)], the
vector-Jacobian product taken by autograd on the ρ-modified layer. The
walk reads one forward's BatchNorm and block outputs (forward hooks) and
runs in float32 even when the model is bfloat16: the ε stabilizer vanishes
in bfloat16, so the walker widens the model's own (rounded) weights. It
runs eagerly, a few hundred small launches on ResNet-50, where the
reference wraps it in one ``jax.jit``; the reference's ``lax.scan`` over a
stage's identical blocks is a plain loop here.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["lrp_resnet", "prepare_lrp_model"]

_FOLDED = "_lrp_folded_float32"  # marks a prepared copy


def _stab(z: torch.Tensor, eps: float) -> torch.Tensor:
    s = z + eps * torch.sign(z)
    return torch.where(s == 0, eps if eps > 0 else 1.0, s)


def _vjp(fn, inputs: tuple, cotangent: torch.Tensor):
    """(fn(*inputs), the vector-Jacobian product of ``cotangent``)."""
    leaves = tuple(t.detach().requires_grad_() for t in inputs)
    with torch.enable_grad():
        z = fn(*leaves)
        grads = torch.autograd.grad(z, leaves, grad_outputs=cotangent(z.detach()))
    return grads


def _rho_step(rho_fwd, x_in: torch.Tensor, R: torch.Tensor, eps: float) -> torch.Tensor:
    """The generic rule: R_in = x ⊙ ρ(W)ᵀ[R / (z_ρ + ε sign z_ρ)]."""
    (c,) = _vjp(rho_fwd, (x_in,), lambda z: R / _stab(z, eps))
    return x_in * c


def _conv_fwd(W: torch.Tensor, b: torch.Tensor | None, stride: int):
    pad = W.shape[-1] // 2

    def f(t):
        out = F.conv2d(t, W, stride=stride, padding=pad)
        return out if b is None else out + b.reshape(1, -1, 1, 1)

    return f


def _conv_site(x_in, W, b, stride: int, R, rule: str, eps: float):
    """One conv(+folded-BatchNorm bias) site under ``rule``."""
    if rule == "zplus":
        Wp, Wn = W.clamp(min=0.0), W.clamp(max=0.0)
        xp, xn = x_in.clamp(min=0.0), x_in.clamp(max=0.0)
        bp = None if b is None else b.clamp(min=0.0)
        fp, fn = _conv_fwd(Wp, None, stride), _conv_fwd(Wn, None, stride)

        def zfwd(p, n):
            z = fp(p) + fn(n)
            return z if bp is None else z + bp.reshape(1, -1, 1, 1)

        cp, cn = _vjp(zfwd, (xp, xn), lambda z: R / _stab(z, eps))
        return xp * cp + xn * cn
    if rule == "flat":
        ones_x = torch.ones_like(x_in)
        (c,) = _vjp(_conv_fwd(torch.ones_like(W), None, stride), (ones_x,),
                    lambda z: R / _stab(z, eps))
        return c
    return _rho_step(_conv_fwd(W, b, stride), x_in, R, eps)


def _maxpool_route(x_in: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Winner-take-all relevance routing through the 3x3/2 stem pool."""
    (c,) = _vjp(lambda t: F.max_pool2d(t, 3, 2, 1), (x_in,), lambda z: R)
    return c


def _add_split(a, b, R, eps: float):
    """Residual add: relevance splits in proportion to the branch values."""
    tot = _stab(a + b, eps)
    return R * a / tot, R * b / tot


def prepare_lrp_model(model: nn.Module) -> nn.Module:
    """The walker's own copy of a ResNet: float32 (a bfloat16 model's
    rounded weights widened; a float64 model stays float64), BatchNorm
    folded into the convs, the 7x7 stem form, the plain ReLU and identity
    ``post_linear``, eval mode. A prepared copy is returned as it is."""
    if getattr(model, _FOLDED, False):
        return model
    from wam_tpu_torch.models.resnet import _fold_bn, _identity

    walker = copy.deepcopy(model).eval()
    if next(walker.parameters()).dtype != torch.float64:
        walker.float()
    walker.requires_grad_(False)
    _fold_bn(walker)  # idempotent on a folded model: the scale is 1 / sqrt(1 - eps + eps)
    walker.stem_s2d = False
    for m in walker.modules():
        if hasattr(m, "act"):
            m.act = torch.relu
        if hasattr(m, "post_linear"):
            m.post_linear = _identity
    setattr(walker, _FOLDED, True)
    return walker


def _capture(walker: nn.Module, inp: torch.Tensor) -> dict:
    """One forward of the prepared model, recording the output of every
    BatchNorm and every residual block by module name."""
    acts, handles = {}, []
    for name, m in walker.named_modules():
        if isinstance(m, nn.BatchNorm2d) or name.count(".") == 1 and name.startswith("layer"):
            handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name: acts.__setitem__(name, out)))
    try:
        with torch.no_grad():
            walker(inp)
    finally:
        for h in handles:
            h.remove()
    return acts


def lrp_resnet(model: nn.Module, x: torch.Tensor, y, *, eps: float = 1e-6,
               composite: str = "epsilon_plus_flat", nchw: bool = True) -> torch.Tensor:
    """EpsilonPlusFlat LRP through a `models.resnet.ResNet`: the (B, H, W)
    channel-summed input relevance, seeded with a one-hot at the picked
    class (output relevance 1, zennit's Gradient attributor's seed).
    ``composite="epsilon"`` applies the ε-rule everywhere instead.
    ``model`` may be a `prepare_lrp_model` copy (the evaluators keep one)."""
    from wam_tpu_torch.models.resnet import Bottleneck, ResNet

    if not isinstance(model, ResNet):
        raise ValueError(f"lrp_resnet walks the ResNet structure; got {type(model).__name__}")
    if composite not in ("epsilon_plus_flat", "epsilon"):
        raise ValueError(f"composite must be 'epsilon_plus_flat' or 'epsilon', got {composite!r}")
    walker = prepare_lrp_model(model)
    inp = (x if nchw else x.permute(0, 3, 1, 2)).to(walker.fc.weight.dtype)
    acts = _capture(walker, inp)
    bottleneck = walker.block_cls is Bottleneck
    conv_rule = "zplus" if composite == "epsilon_plus_flat" else "epsilon"
    first_rule = "flat" if composite == "epsilon_plus_flat" else "epsilon"

    # ---- output seed: a one-hot at the picked class (a scatter: F.one_hot
    # reads the labels back to check them, a wait on the device)
    yy = torch.as_tensor(y, device=inp.device).long()
    R = torch.zeros((inp.shape[0], walker.fc.out_features), dtype=inp.dtype, device=inp.device)
    R.scatter_(1, yy[:, None], 1.0)

    sizes = walker.stage_sizes
    last = acts[f"layer{len(sizes)}.{sizes[-1] - 1}"]
    pooled = last.mean(dim=(2, 3))
    # ---- fc (ε rule), then the global mean (proportional spread)
    R = _rho_step(lambda t: F.linear(t, walker.fc.weight, walker.fc.bias), pooled, R, eps)
    s = R / _stab(pooled * (last.shape[2] * last.shape[3]), eps)
    R = last * s[:, :, None, None]

    stem_relu = torch.relu(acts["bn1"])
    stem_pool = F.max_pool2d(stem_relu, 3, 2, 1)

    def block_step(name: str, block, x_in, R):
        """Relevance through one residual block, from its captured outputs."""
        bn = {k: acts[f"{name}.{k}"] for k in ("bn1", "bn2", "bn3") if f"{name}.{k}" in acts}
        a1 = torch.relu(bn["bn1"])
        main_out = bn["bn3"] if bottleneck else bn["bn2"]
        res_out = x_in if block.downsample is None else acts[f"{name}.downsample.1"]
        R_main, R_res = _add_split(main_out, res_out, R, eps)
        stride = block.conv2.stride[0] if bottleneck else block.conv1.stride[0]
        if bottleneck:
            R_main = _conv_site(torch.relu(bn["bn2"]), block.conv3.weight, block.bn3.bias, 1,
                                R_main, conv_rule, eps)
            R_main = _conv_site(a1, block.conv2.weight, block.bn2.bias, stride, R_main,
                                conv_rule, eps)
            R_main = _conv_site(x_in, block.conv1.weight, block.bn1.bias, 1, R_main,
                                conv_rule, eps)
        else:
            R_main = _conv_site(a1, block.conv2.weight, block.bn2.bias, 1, R_main,
                                conv_rule, eps)
            R_main = _conv_site(x_in, block.conv1.weight, block.bn1.bias, stride, R_main,
                                conv_rule, eps)
        if block.downsample is not None:
            R_res = _conv_site(x_in, block.downsample[0].weight, block.downsample[1].bias,
                               block.downsample[0].stride[0], R_res, conv_rule, eps)
        return R_main + R_res

    # ---- stages, backwards
    for s_idx in range(len(sizes) - 1, -1, -1):
        stage = getattr(walker, f"layer{s_idx + 1}")
        for i in range(sizes[s_idx] - 1, -1, -1):
            if i > 0:
                x_in = acts[f"layer{s_idx + 1}.{i - 1}"]
            elif s_idx > 0:
                x_in = acts[f"layer{s_idx}.{sizes[s_idx - 1] - 1}"]
            else:
                x_in = stem_pool
            R = block_step(f"layer{s_idx + 1}.{i}", stage[i], x_in, R)

    # ---- the stem: the pool's routing, then the 7x7/2 conv
    R = _maxpool_route(stem_relu, R)
    R = _conv_site(inp, walker.conv1.weight, walker.bn1.bias, 2, R, first_rule, eps)
    return R.sum(dim=1)
