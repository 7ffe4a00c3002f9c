"""K1 ``forward``: the batched forward model as one CUDA kernel.

``forward`` is the wrapper the model calls (``design.model_yhat`` and
``predict.forecast``).  On a CPU tensor it runs the plain PyTorch
version, ``forward_plain`` (the port's ``trend_fn`` and
``seasonal_split``); on a CUDA tensor it launches
``csrc/forward.cu`` or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import build

#: Kernel launches since the count was last set to 0.
launches = 0

GROWTH_CODES = {"linear": 0, "logistic": 1, "flat": 2}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def forward_plain(theta: torch.Tensor, data, config: ProphetConfig,
                  y_scale: Optional[torch.Tensor] = None,
                  floor: Optional[torch.Tensor] = None) -> Outputs:
    """(yhat, trend, additive, multiplicative), each (B, T): scaled
    units, or data units when ``y_scale`` and ``floor`` (B,) are given."""
    from tsspark_tpu_torch.models.prophet.design import (
        seasonal_split,
        trend_fn,
    )
    from tsspark_tpu_torch.models.prophet.params import unpack

    g = trend_fn(unpack(theta, config), data, config)
    add, mult = seasonal_split(theta, data, config)
    yhat = g * (1.0 + mult) + add
    if y_scale is None:
        return yhat, g, add, mult
    sc, fl = y_scale[:, None], floor[:, None]
    return yhat * sc + fl, g * sc + fl, add * sc, mult


def _require(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(
            f"{name}: expected float32 on {device}, got {x.dtype} on "
            f"{x.device}"
        )
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned16(*tensors: torch.Tensor):
    """The tensors, each copied if its data does not start on a 16-byte
    boundary: the kernels stage rows by 16-byte bulk copies."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone()
                 for x in tensors)


def forward(theta: torch.Tensor, data, config: ProphetConfig,
            y_scale: Optional[torch.Tensor] = None,
            floor: Optional[torch.Tensor] = None) -> Outputs:
    """The forward model; see ``forward_plain`` for the outputs."""
    global launches
    dev = theta.device
    if dev.type == "cpu":
        return forward_plain(theta, data, config, y_scale, floor)
    if dev.type != "cuda":
        raise ValueError(f"forward: unsupported device {dev}")
    b, t_len = data.t.shape
    ncp = config.n_changepoints
    fs = config.num_seasonal_features
    r = config.num_regressors
    _require("theta", theta, (b, config.num_params), dev)
    _require("t", data.t, (b, t_len), dev)
    _require("s", data.s, (b, ncp), dev)
    xs = data.X_season
    if xs.ndim == 2:
        _require("X_season", xs, (t_len, fs), dev)
        xs_bstride = 0
    else:
        _require("X_season", xs, (b, t_len, fs), dev)
        xs_bstride = t_len * fs
    _require("X_reg", data.X_reg, (b, t_len, r), dev)
    _require("mult_mask", data.mult_mask, (fs + r,), dev)
    growth = GROWTH_CODES[config.growth]
    if growth == GROWTH_CODES["logistic"]:
        _require("cap", data.cap, (b, t_len), dev)
    if (y_scale is None) != (floor is None):
        raise ValueError("pass y_scale and floor together")
    if y_scale is not None:
        _require("y_scale", y_scale, (b,), dev)
        _require("floor", floor, (b,), dev)
    lib = build.library()
    if not lib.tsspark_forward_smem(t_len, ncp, fs, r, int(xs_bstride != 0),
                                    growth):
        raise ValueError("forward: too many changepoints and features for "
                         "a block's shared memory")
    # The kernel stages its rows by 16-byte bulk copies.
    t, xs, xr = aligned16(data.t, xs, data.X_reg)
    cap = aligned16(data.cap)[0] if growth == GROWTH_CODES["logistic"] \
        else None
    outs = tuple(torch.empty((b, t_len), dtype=torch.float32, device=dev)
                 for _ in range(4))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tsspark_forward(
            theta.data_ptr(), t.data_ptr(), ptr(data.s), ptr(cap),
            xs.data_ptr(), xs_bstride, xr.data_ptr(),
            ptr(data.mult_mask), ptr(y_scale), ptr(floor),
            *(o.data_ptr() for o in outs),
            b, t_len, config.num_params, ncp, fs, r, growth, stream,
        )
    build.check(err, "forward")
    launches += 1
    return outs
