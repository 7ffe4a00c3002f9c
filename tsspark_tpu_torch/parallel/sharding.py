"""Sharded batched fitting: collect -> shard -> fit -> scatter (the port's
copy of the JAX package's ``parallel.sharding``).

The JAX package writes the MAP solve as one jitted program with sharding
annotations and lets GSPMD partition it.  The port has no partitioner, so
a "sharding" here is explicit: a leaf's row slice (series axis) or
row-and-time block (series and time axes), placed on its mesh entry's
device (``make_shard_and_gather_fns``).

  * series axis: every per-series quantity splits on its B dim; all
    solver math is per row, so each series shard runs its own solve, one
    after another.  On each shard the work is exactly the single-device
    program (``fit_core_packed``) over that shard's rows.
  * time axis (sequence parallelism): the loss's time sums split over the
    time shards.  Each time shard computes its block's partial sums (K3
    for the loss and gradient, K4 for the line-search fan, on the card;
    their plain versions on the CPU), treating the block as a
    ``(B, T_block)`` problem; the prior terms count once, on the first
    block only (the other blocks run with every prior scale at +inf,
    whose terms are exactly 0); the partial sums are added on the series
    shard's first device.  The warm start and the GN-diagonal metric are
    computed once there over the shard's rows assembled whole, so that
    device holds every block's rows while it solves.  The float32
    sum order differs from the one-device solve's, so a time-sharded fit
    is held at tolerance, never bitwise.

The width ladder (``next_pow2`` / ``compacted_width``) is shared with the
serving engine's buckets and the backend's chunk sizes.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig, ShardingConfig, SolverConfig


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def compacted_width(n_live: int, floor: int = 32, multiple: int = 1) -> int:
    """Padded batch width for ``n_live`` rows: the next power of two,
    floored at ``floor`` and rounded up to a ``multiple`` (a series-shard
    count, so a compacted width still divides evenly across shards), so
    widths walk one short ladder and every width is one the card has seen
    before."""
    w = next_pow2(max(int(n_live), 1))
    return pad_to_multiple(max(w, int(floor)), max(int(multiple), 1))


def _ndim(a) -> int:
    return a.ndim if hasattr(a, "ndim") else np.ndim(a)


def _shape(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None``: not split), a tuple as
    ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _resolve_time_axis(mesh, config: ShardingConfig):
    """The time axis of a layout: the config's declared name wins; else an
    axis literally named "time"; else the first mesh axis that is not the
    series axis.  Shared by the plain and packed spec builders."""
    t_ax = config.time_axis
    if t_ax is None:
        rest = [n for n in mesh.axis_names if n != config.series_axis]
        if "time" in rest:
            return "time"
        t_ax = rest[0] if rest else None
    return t_ax


def data_shardings(mesh, data, config: ShardingConfig):
    """PartitionSpecs for each FitData leaf (shaped like the tuple)."""
    from tsspark_tpu_torch.models.prophet.design import FitData

    s_ax = config.series_axis
    t_ax = _resolve_time_axis(mesh, config)
    bt = P(s_ax, t_ax)
    return FitData(
        t=bt,
        y=bt,
        mask=bt,
        s=P(s_ax, None),
        cap=bt,
        X_season=P(t_ax, None) if _ndim(data.X_season) == 2
        else P(s_ax, t_ax, None),
        X_reg=P(s_ax, t_ax, None),
        prior_scales=P(None),
        mult_mask=P(None),
    )


def packed_shardings(mesh, packed, config: ShardingConfig):
    """PartitionSpecs for each PackedFitData leaf: per-series leaves split
    on the series axis, time-major leaves also on the time axis.
    ``X_reg_bits`` (8 time steps a byte) stays whole along time."""
    from tsspark_tpu_torch.models.prophet.design import PackedFitData

    s_ax = config.series_axis
    t_ax = _resolve_time_axis(mesh, config)
    return PackedFitData(
        y=P(s_ax, t_ax),
        ds_rel=P(t_ax),
        t_off=P(s_ax),
        t_inv_span=P(s_ax),
        s=P(s_ax, None),
        cap=P(s_ax, None) if _shape(packed.cap)[-1] == 1 else P(s_ax, t_ax),
        X_season=(
            P(t_ax, None) if _ndim(packed.X_season) == 2
            else P(s_ax, t_ax, None)
        ),
        X_reg=P(s_ax, t_ax, None),
        X_reg_bits=P(s_ax, None, None),
        prior_scales=P(None),
        mult_mask=P(None),
    )


# ---------------------------------------------------------------------------
# partition rules + shard/gather fns (the mesh-resident feed machinery)
# ---------------------------------------------------------------------------

def match_partition_rules(rules: Sequence[Tuple[str, P]], tree):
    """PartitionSpec tuple for a NamedTuple batch: each field name is
    matched against ``rules`` (ordered ``(regex, PartitionSpec)`` pairs,
    first match wins), trimmed to the leaf's rank.  Scalar leaves never
    split.  Raises on a field no rule matches."""

    def spec_for(name: str, leaf):
        if _ndim(leaf) == 0:
            return P()
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                return P(*spec[: _ndim(leaf)])
        raise ValueError(f"no partition rule matches field {name!r}")

    return type(tree)(**{
        name: spec_for(name, getattr(tree, name)) for name in tree._fields
    })


def resident_partition_rules(series_axis: str,
                             x_season_per_series: bool
                             ) -> Tuple[Tuple[str, P], ...]:
    """THE partition rules of the mesh-resident fit feed
    (``tsspark_tpu_torch.resident``): per-series leaves split on the
    series axis, shared design tensors are copied to every shard.  Time
    is never split, so each shard's program is the one-device program."""
    shared = r"^(ds_rel|prior_scales|mult_mask)$" \
        if x_season_per_series else r"^(ds_rel|prior_scales|mult_mask|X_season)$"
    return (
        (shared, P()),
        (r".*", P(series_axis, None, None)),
    )


def pad_packed_rows(packed, k: int):
    """``packed`` with ``k`` inert series rows appended (host numpy):
    all-NaN ``y`` (the packed encoding of an all-masked series), zeroed
    time encoding, positive logistic cap.  THE padding rule shared by
    ``fit_sharded_packed`` and the resident feed."""
    if k <= 0:
        return packed

    def pad_rows(a, fill):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.full((k,) + a.shape[1:], fill, a.dtype)]
        )

    return packed._replace(
        y=pad_rows(packed.y, np.nan),
        t_off=pad_rows(packed.t_off, 0.0),
        t_inv_span=pad_rows(packed.t_inv_span, 0.0),
        s=pad_rows(packed.s, 0.0),
        cap=pad_rows(packed.cap, 1.0),
        X_reg=pad_rows(packed.X_reg, 0.0),
        X_reg_bits=pad_rows(packed.X_reg_bits, 0),
        X_season=(
            packed.X_season if np.ndim(packed.X_season) == 2
            else pad_rows(packed.X_season, 0.0)
        ),
    )


def _bounds(n: int, parts: int) -> List[int]:
    """Block boundaries of ``n`` cells in ``parts`` near-equal blocks."""
    return [(n * i) // parts for i in range(parts + 1)]


class ShardedArray:
    """One leaf laid out over a mesh: ``blocks[i][j]`` is the tensor of
    series shard ``i`` and time shard ``j`` on ``mesh.devices[i, j]`` (a
    leaf not split on an axis holds the whole extent there).
    ``np.asarray`` gathers it back to host numpy."""

    def __init__(self, mesh, spec: P, blocks, shape):
        self.mesh = mesh
        self.spec = spec
        self.blocks = blocks
        self.shape = tuple(shape)

    def _dim(self, axis: str) -> Optional[int]:
        return next((d for d, a in enumerate(self.spec) if a == axis), None)

    def __array__(self, dtype=None, copy=None):
        s_name, t_name = self.mesh.axis_names
        s_dim, t_dim = self._dim(s_name), self._dim(t_name)
        n_s, n_t = self.mesh.devices.shape
        rows = []
        for i in range(n_s if s_dim is not None else 1):
            cols = [self.blocks[i][j].detach().cpu().numpy()
                    for j in range(n_t if t_dim is not None else 1)]
            rows.append(np.concatenate(cols, axis=t_dim)
                        if t_dim is not None else cols[0])
        out = (np.concatenate(rows, axis=s_dim)
               if s_dim is not None else rows[0])
        return out if dtype is None else out.astype(dtype)


def _place(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_array(mesh, spec: P, a) -> ShardedArray:
    """Place ``a`` (host numpy or a tensor) under ``spec``: each mesh
    entry gets its block, and only its block, on its device."""
    s_name, t_name = mesh.axis_names
    n_s, n_t = mesh.devices.shape
    shape = _shape(a)
    cuts = []
    for d in range(len(shape)):
        axis = spec[d] if d < len(spec) else None
        if axis == s_name:
            cuts.append(("s", _bounds(shape[d], n_s)))
        elif axis == t_name:
            cuts.append(("t", _bounds(shape[d], n_t)))
        elif axis is None:
            cuts.append(None)
        else:
            raise ValueError(f"spec {spec} names axis {axis!r}, not one of "
                             f"the mesh's {mesh.axis_names}")
    blocks = []
    for i in range(n_s):
        row = []
        for j in range(n_t):
            idx = []
            for c in cuts:
                if c is None:
                    idx.append(slice(None))
                else:
                    k = i if c[0] == "s" else j
                    idx.append(slice(c[1][k], c[1][k + 1]))
            row.append(_place(a[tuple(idx)], mesh.devices[i, j]))
        blocks.append(row)
    return ShardedArray(mesh, spec, blocks, shape)


def make_shard_and_gather_fns(mesh, specs):
    """(shard_fns, gather_fns) tuples shaped like the PartitionSpec tuple
    ``specs``: ``shard_fns`` place host arrays as ``ShardedArray``s (each
    device receives only its block), ``gather_fns`` pull one back to host
    numpy.  Apply leaf by leaf: ``type(t)(*(f(x) for f, x in zip(fns,
    t)))``."""
    shard = type(specs)(*(
        (lambda a, sp=sp: shard_array(mesh, sp, a)) for sp in specs
    ))
    gather = type(specs)(*((lambda a: np.asarray(a)) for _ in specs))
    return shard, gather


def apply_fns(fns, tree):
    """``fns`` applied leaf by leaf to a tuple of the same type."""
    return type(tree)(*(f(x) for f, x in zip(fns, tree)))


# ---------------------------------------------------------------------------
# the resident program and the sharded fits
# ---------------------------------------------------------------------------

def _phase_solver(solver_config: SolverConfig, max_iters_dynamic,
                  gn_precond_dynamic) -> SolverConfig:
    """The reference's traced phase controls as the port's solver config:
    the depth capped at ``max_iters_dynamic``, the GN-diagonal metric on
    or off (None keeps the config's own)."""
    upd = {}
    if max_iters_dynamic is not None:
        upd["max_iters"] = min(int(max_iters_dynamic),
                               int(solver_config.max_iters))
    if gn_precond_dynamic is not None:
        upd["precond"] = "gn_diag" if bool(gn_precond_dynamic) else "none"
    return dataclasses.replace(solver_config, **upd) if upd else solver_config


def fit_resident_core(
    packed,
    theta0: ShardedArray,
    config: ProphetConfig,
    solver_config: SolverConfig,
    reg_u8_cols: Tuple[int, ...] = (),
    max_iters_dynamic=None,
    gn_precond_dynamic=None,
    use_theta0_dynamic=None,
):
    """The mesh-resident fit program (``tsspark_tpu_torch.resident``).

    ``packed`` is a PackedFitData of ``ShardedArray`` leaves laid out by
    the resident partition rules (series axis only) and ``theta0`` the
    (B, P) init under ``P(series, None)``.  Each series shard runs
    EXACTLY ``fit_core_packed`` on its device over its rows, with the
    phase controls applied as the chunk workers apply them: depth and
    metric through the solver config, and the ridge init unless
    ``use_theta0_dynamic`` (then ``theta0``'s rows).  Returns ``(theta,
    stats)`` as ``ShardedArray``s under ``P(series, None)`` / ``P(None,
    series)``; ``np.asarray`` gathers them.

    The inputs are read, never written: the solver builds its own state
    from ``theta0``, so a wave still in flight never sees another wave's
    writes (the reference's donation fault has no counterpart while
    every wave gets fresh inputs, which ``resident`` guarantees)."""
    from tsspark_tpu_torch.models.prophet.design import PackedFitData
    from tsspark_tpu_torch.models.prophet.model import fit_core_packed

    mesh = theta0.mesh
    solver = _phase_solver(solver_config, max_iters_dynamic,
                           gn_precond_dynamic)
    use0 = True if use_theta0_dynamic is None else bool(use_theta0_dynamic)
    th_blocks, st_blocks = [], []
    for i in range(mesh.devices.shape[0]):
        shard = PackedFitData(*(leaf.blocks[i][0] for leaf in packed))
        th, st = fit_core_packed(
            shard, theta0.blocks[i][0] if use0 else None, config, solver,
            reg_u8_cols=tuple(reg_u8_cols),
        )
        th_blocks.append([th])
        st_blocks.append([st])
    b, p = theta0.shape
    s_ax = mesh.axis_names[0]
    return (ShardedArray(mesh, P(s_ax, None), th_blocks, (b, p)),
            ShardedArray(mesh, P(None, s_ax), st_blocks, (5, b)))


def _priorless(config: ProphetConfig) -> ProphetConfig:
    """``config`` with every prior scale at +inf: each prior term (and its
    gradient) is then exactly 0, so a time block's loss is its likelihood
    partial sum alone."""
    inf = math.inf
    return dataclasses.replace(config, k_prior_scale=inf, m_prior_scale=inf,
                               sigma_prior_scale=inf,
                               changepoint_prior_scale=inf)


def _time_blocks(data, mesh, shard_cfg):
    """``data`` under ``data_shardings``: for each series shard, its time
    shards' blocks (each a FitData on its own device)."""
    from tsspark_tpu_torch.models.prophet.design import FitData

    specs = data_shardings(mesh, data, shard_cfg)
    leaves = [shard_array(mesh, sp, a) for sp, a in zip(specs, data)]
    n_s, n_t = mesh.devices.shape
    return [[FitData(*(leaf.blocks[i][j].to(torch.float32)
                       for leaf in leaves)) for j in range(n_t)]
            for i in range(n_s)]


def _assemble(blocks, device):
    """The blocks' rows over the whole time axis, on ``device``."""
    from tsspark_tpu_torch.models.prophet.design import FitData

    if len(blocks) == 1:
        return blocks[0]
    first = blocks[0]
    out = {}
    for name in FitData._fields:
        parts = [getattr(b, name).to(device) for b in blocks]
        a = getattr(first, name)
        if name in ("s", "prior_scales", "mult_mask"):
            out[name] = parts[0]
        elif name == "X_season":
            out[name] = torch.cat(parts, dim=0 if a.ndim == 2 else 1)
        else:
            out[name] = torch.cat(parts, dim=1)
    return FitData(**out)


def _block_objective(blocks, config):
    """The solver's ``(fun, fval, fan)`` as sums over time blocks (see the
    module docstring): K3 / K4 (or their plain versions) per block, the
    prior on block 0 only, partial sums added on block 0's device."""
    from tsspark_tpu_torch.models.prophet.loss import (
        fan_value_closed_form,
        has_closed_form_fan,
        value_and_grad_batch,
        value_batch,
    )

    dev0 = blocks[0].y.device
    bare = _priorless(config)
    cfgs = [config] + [bare] * (len(blocks) - 1)
    blocks = [blocks[0]] + [
        b._replace(prior_scales=torch.full_like(b.prior_scales, math.inf))
        for b in blocks[1:]
    ]

    def on(t, b):
        return t.to(b.y.device)

    def fun(th):
        f = g = None
        for b, c in zip(blocks, cfgs):
            fb, gb = value_and_grad_batch(on(th, b), b, c)
            f = fb.to(dev0) if f is None else f + fb.to(dev0)
            g = gb.to(dev0) if g is None else g + gb.to(dev0)
        return f, g

    def fval(th):
        f = None
        for b, c in zip(blocks, cfgs):
            fb = value_batch(on(th, b), b, c).to(dev0)
            f = fb if f is None else f + fb
        return f

    fan = None
    if has_closed_form_fan(config):
        def fan(th, d, s):
            out = None
            for b, c in zip(blocks, cfgs):
                fb = fan_value_closed_form(on(th, b), on(d, b), on(s, b),
                                           b, c).to(dev0)
                out = fb if out is None else out + fb
            return out

    return fun, fval, fan


def _solve_shard(blocks, theta0, config, solver_config):
    """One series shard's solve: ``fit_core`` over its one block, or, over
    several time blocks, ``fit_core`` with the block-summed objective.
    The warm start and the GN-diagonal metric are then computed over the
    shard's rows assembled on block 0's device (``_assemble``): the
    time split divides the loss's work, not the init's memory."""
    from tsspark_tpu_torch.models.prophet.model import fit_core

    if len(blocks) == 1:
        return fit_core(blocks[0], theta0, config, solver_config)
    return fit_core(_assemble(blocks, blocks[0].y.device), theta0, config,
                    solver_config,
                    objective=_block_objective(blocks, config))


def _fit_sharded_core(data, theta0, config, solver_config, mesh, shard_cfg):
    """Every series shard's solve, one after another; the results come
    back concatenated on the host (CPU tensors)."""
    from tsspark_tpu_torch.ops import lbfgs

    n_s = mesh.devices.shape[0]
    b = int(_shape(data.y)[0])
    cuts = _bounds(b, n_s)
    parts = []
    for i, blocks in enumerate(_time_blocks(data, mesh, shard_cfg)):
        th0 = None if theta0 is None else theta0[cuts[i]:cuts[i + 1]]
        res = _solve_shard(blocks, th0, config, solver_config)
        parts.append(lbfgs.LbfgsResult(*(a.detach().cpu() for a in res)))
    return lbfgs.LbfgsResult(*(torch.cat(xs, dim=0) for xs in zip(*parts)))


def _padded_theta(theta0, k):
    th = np.asarray(theta0 if not isinstance(theta0, torch.Tensor)
                    else theta0.detach().cpu().numpy(), np.float32)
    return np.concatenate([th, np.zeros((k,) + th.shape[1:], th.dtype)])


def fit_sharded(
    data,
    theta0,
    config: ProphetConfig,
    solver_config: SolverConfig,
    mesh,
    shard_cfg: ShardingConfig = ShardingConfig(),
):
    """Fit a FitData batch (host numpy or tensors) across the mesh; pads B
    to the series-shard count with inert all-masked rows.

    ``theta0=None`` computes the warm start inside each series shard's
    solve (the ridge init over that shard's rows).  Returns an
    ``LbfgsResult`` of CPU tensors for the ORIGINAL (unpadded) batch."""
    from tsspark_tpu_torch.models.prophet.design import FitData

    b = int(_shape(data.y)[0])
    n_series_shards = mesh.shape[shard_cfg.series_axis]
    b_pad = pad_to_multiple(b, n_series_shards)
    host = lambda a: (a.detach().cpu().numpy()  # noqa: E731
                      if isinstance(a, torch.Tensor) else np.asarray(a))
    data = FitData(*(host(a) for a in data))
    if b_pad != b:
        k = b_pad - b

        def pad_b(a, fill=0.0):
            return np.concatenate(
                [a, np.full((k,) + a.shape[1:], fill, a.dtype)])

        data = data._replace(
            t=pad_b(data.t), y=pad_b(data.y), mask=pad_b(data.mask),
            s=pad_b(data.s), cap=pad_b(data.cap, 1.0),
            X_season=(data.X_season if data.X_season.ndim == 2
                      else pad_b(data.X_season)),
            X_reg=pad_b(data.X_reg),
        )
        if theta0 is not None:
            theta0 = _padded_theta(theta0, k)
    if theta0 is not None:
        theta0 = torch.as_tensor(np.asarray(theta0, np.float32))
    res = _fit_sharded_core(data, theta0, config, solver_config, mesh,
                            shard_cfg)
    if b_pad != b:
        res = type(res)(*(a[:b] for a in res))
    return res


def _fit_sharded_packed_core(packed, theta0, config, solver_config, mesh,
                             shard_cfg, reg_u8_cols):
    """The packed feed's solves: each series shard's packed rows go to the
    shard's first device (the NaN-folded mask, bit-packed indicators and
    the affine time map cross the link, not the (B, T) expansion), are
    unpacked there, and the unpacked rows split into the shard's time
    blocks.  ``packed`` is padded to the series-shard count already."""
    from tsspark_tpu_torch.models.prophet.design import (
        PackedFitData,
        unpack_fit_data,
    )
    from tsspark_tpu_torch.ops import lbfgs

    s_ax = shard_cfg.series_axis
    n_s = mesh.shape[s_ax]
    # Series split only: the unpack needs each row's whole time axis (the
    # indicator bits are 8 steps a byte); the time split follows it.
    specs = PackedFitData(*(
        P(*(a if a == s_ax else None for a in sp)) for sp in
        packed_shardings(mesh, packed, shard_cfg)))
    first_col = type(mesh)(mesh.devices[:, :1], mesh.axis_names)
    leaves = [shard_array(first_col, sp, a) for sp, a in zip(specs, packed)]
    cuts = _bounds(int(_shape(packed.y)[0]), n_s)
    parts = []
    for i in range(n_s):
        shard = PackedFitData(*(leaf.blocks[i][0] for leaf in leaves))
        data = unpack_fit_data(shard, tuple(reg_u8_cols))
        sub_mesh = type(mesh)(mesh.devices[i:i + 1], mesh.axis_names)
        blocks = _time_blocks(data, sub_mesh, shard_cfg)[0]
        th0 = None if theta0 is None else theta0[cuts[i]:cuts[i + 1]]
        res = _solve_shard(blocks, th0, config, solver_config)
        parts.append(lbfgs.LbfgsResult(*(a.detach().cpu() for a in res)))
    return lbfgs.LbfgsResult(*(torch.cat(xs, dim=0) for xs in zip(*parts)))


def fit_sharded_packed(
    packed,
    reg_u8_cols: Tuple[int, ...],
    theta0,
    config: ProphetConfig,
    solver_config: SolverConfig,
    mesh,
    shard_cfg: ShardingConfig = ShardingConfig(),
):
    """Packed-transit analog of ``fit_sharded`` (``_fit_sharded_packed_core``
    says what crosses the link).  Padding rows are ``pad_packed_rows``'s
    inert all-NaN series."""
    b = int(_shape(packed.y)[0])
    n_s = mesh.shape[shard_cfg.series_axis]
    b_pad = pad_to_multiple(b, n_s)
    if b_pad != b:
        packed = pad_packed_rows(packed, b_pad - b)
        if theta0 is not None:
            theta0 = _padded_theta(theta0, b_pad - b)
    if theta0 is not None:
        theta0 = torch.as_tensor(np.asarray(theta0, np.float32))
    res = _fit_sharded_packed_core(packed, theta0, config, solver_config,
                                   mesh, shard_cfg, reg_u8_cols)
    if b_pad != b:
        res = type(res)(*(a[:b] for a in res))
    return res
