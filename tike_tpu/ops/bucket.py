"""Bucket laminography operator: direct voxel-to-plane projection.

JAX equivalent of `upstream/src/tike/operators/cupy/bucket.py`
and its CUDA kernels (`bucket.cu:66-144`). Each voxel is sub-sampled into
precision^3 points; each point is projected onto the tilted/rotated detector
plane and accumulated with constant weight 1/precision^3. The adjoint gathers
plane values back to voxels — a pure gather (no atomics).

The voxel `grid` argument is an (G, 3) integer array of origin-centered voxel
coordinates; splitting it along axis 0 splits the volume across processes —
the reference's object-domain model parallelism (`bucket.py:267-274`). The
matching `u` chunk must contain the same voxels in the same (C) order, so
``u.ravel()[g]`` is the value of voxel ``grid[g]``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Static configuration of the Bucket laminography operator."""

    n: int
    tilt: float
    precision: int = 1

    @classmethod
    def from_eps(cls, n: int, tilt: float, eps: float = 1.0):
        """Pick the sub-sampling precision so 1/precision^3 <= eps."""
        precision = 1
        while (1 / precision**3) > eps:
            precision += 1
        return cls(n=n, tilt=tilt, precision=precision)


def make_grid(n: int, size: int = 1, rank: int = 0) -> np.ndarray:
    """Origin-centered integer voxel coordinates, split by rank.

    Mirrors `Bucket._make_grid` (`bucket.py:267-274`).
    """
    lo, hi = -n // 2, n // 2
    grid = np.stack(np.mgrid[lo:hi, lo:hi, lo:hi], axis=-1)
    return np.array_split(grid, size)[rank].reshape(-1, 3).astype(np.int32)


def _subsample_offsets(precision: int) -> np.ndarray:
    """The precision^3 sub-voxel sample offsets (i+0.5)/precision."""
    c = (np.arange(precision) + 0.5) / precision
    i, j, k = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([i.ravel(), j.ravel(), k.ravel()], -1).astype(np.float32)


def _plane_flat_indices(cfg: BucketConfig, grid, off, theta_t):
    """Project sub-sampled voxel points onto the plane; return flat indices.

    Implements forward_rotation / project_point_to_plane / reverse_rotation
    (`bucket.cu:22-104`).
    """
    n = cfg.n
    ct, st = jnp.cos(cfg.tilt), jnp.sin(cfg.tilt)
    cq, sq = jnp.cos(theta_t), jnp.sin(theta_t)
    # normal = forward_rotation((1, 0, 0))
    nx, ny, nz = ct, -cq * st, -sq * st

    p = grid.astype(jnp.float32) + off[None, :]  # (G, 3)
    d = p[:, 0] * nx + p[:, 1] * ny + p[:, 2] * nz
    px = p[:, 0] - d * nx
    py = p[:, 1] - d * ny
    pz = p[:, 2] - d * nz
    # reverse rotation: in-plane (y, z) coordinates
    y = st * px + cq * ct * py + sq * ct * pz
    z = -sq * py + cq * pz
    iy = (jnp.floor(y).astype(jnp.int32) + n // 2) % n
    iz = (jnp.floor(z).astype(jnp.int32) + n // 2) % n
    return iy * n + iz


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_fwd(cfg: BucketConfig, u, theta, grid):
    """Forward projection: volume chunk -> (ntheta, n, n) complex data."""
    u_flat = u.reshape(-1)
    assert u_flat.shape[0] == grid.shape[0], (u.shape, grid.shape)
    weight = jnp.asarray(1.0 / cfg.precision**3, dtype=u.real.dtype)
    offsets = jnp.asarray(_subsample_offsets(cfg.precision))

    # Scatter the (re, im) float channels.
    uf = jnp.stack([u_flat.real, u_flat.imag], axis=-1)  # (G, 2)

    def per_theta(theta_t):
        def body(acc, off):
            flat = _plane_flat_indices(cfg, grid, off, theta_t)
            return acc.at[flat].add(uf * weight), None

        acc0 = jnp.zeros((cfg.n * cfg.n, 2), dtype=u.real.dtype)
        acc, _ = jax.lax.scan(body, acc0, offsets)
        return jax.lax.complex(acc[:, 0], acc[:, 1]).astype(u.dtype).reshape(
            cfg.n, cfg.n
        )

    return jax.lax.map(per_theta, theta)


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_adj(cfg: BucketConfig, data, theta, grid):
    """Adjoint projection: data -> volume chunk (gather per voxel)."""
    weight = jnp.asarray(1.0 / cfg.precision**3, dtype=data.real.dtype)
    offsets = jnp.asarray(_subsample_offsets(cfg.precision))

    def per_theta(carry, inputs):
        theta_t, plane = inputs
        pf = jnp.stack(
            [plane.real, plane.imag], axis=-1
        ).reshape(-1, 2)  # float-pair gather

        def body(acc, off):
            flat = _plane_flat_indices(cfg, grid, off, theta_t)
            return acc + pf[flat] * weight, None

        acc, _ = jax.lax.scan(body, carry, offsets)
        return acc, None

    u0 = jnp.zeros((grid.shape[0], 2), dtype=data.real.dtype)
    u, _ = jax.lax.scan(per_theta, u0, (theta, data))
    return jax.lax.complex(u[:, 0], u[:, 1]).astype(data.dtype)


def make_grid_full(n: int) -> np.ndarray:
    """The (n, n, n, 3) origin-centered voxel coordinate lattice.

    Sharding axis 0 of this array (and of the volume) over a mesh axis
    yields exactly the per-rank chunks of ``make_grid(n, size, rank)`` —
    x-slabs in C order — so the sharded and chunked formulations agree.
    """
    lo, hi = -n // 2, n // 2
    return np.stack(np.mgrid[lo:hi, lo:hi, lo:hi], axis=-1).astype(np.int32)


def sharded_bucket_ops(cfg: BucketConfig, mesh, axis: str, raw: bool = False):
    """Volume-model-parallel fwd/adj/grad over a mesh axis.

    The reference's ``obj_split`` device groups hold volume chunks and
    Allreduce their partial projections
    (`upstream/src/tike/lamino/solvers/bucket.py:34-54`,
    `operators/cupy/bucket.py:267-274`); here each device owns an x-slab of
    the volume (axis 0 sharded), scatters its voxels' contributions into a
    full detector plane, and a single ``psum`` over the mesh axis reproduces
    the grouped Allreduce. The adjoint needs no collective: each device
    gathers only its own voxels from the (replicated) projections — the
    owner-local gradients of the reference's strided ``reduce_gpu``.

    Returns ``(fwd, adj, cost, grad, step_scale)`` acting on ((n, n, n)
    volume sharded on axis 0, replicated theta/data, (n, n, n, 3) grid
    sharded on axis 0). With ``raw=True`` the callables are traceable
    (not jitted), for composition inside a fused solver program.
    """
    import jax
    from jax.sharding import PartitionSpec as P

    def _fwd_local(u, theta, grid4):
        return bucket_fwd(cfg, u.reshape(-1), theta, grid4.reshape(-1, 3))

    def _adj_local(data, theta, grid4):
        out = bucket_adj(cfg, data, theta, grid4.reshape(-1, 3))
        return out.reshape(grid4.shape[:3])

    # check_vma=False: the scatter-accumulate scan inside bucket_fwd seeds
    # its carry with an unvarying zeros array, which jax's varying-axis
    # tracking rejects inside shard_map even though the computation is
    # correct (each device accumulates only its own voxels).
    fwd_sm = jax.shard_map(
        lambda u, theta, grid4: jax.lax.psum(
            _fwd_local(u, theta, grid4), axis
        ),
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    adj_sm = jax.shard_map(
        _adj_local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    # Raw traceable versions (shard_map composes with an enclosing jit):
    # the fused whole-CG-iteration program uses these so all inner cost/
    # grad evaluations share ONE dispatch.
    def cost_raw(data, u, theta, grid4):
        return bucket_cost(data, fwd_sm(u, theta, grid4))

    def grad_raw(data, u, theta, grid4):
        fd = fwd_sm(u, theta, grid4)
        g = adj_sm(fd - data, theta, grid4)
        return g / (data.shape[-3] * cfg.n**3)

    def step_raw(u, theta, grid4):
        import tike_tpu.linalg as _la

        back = adj_sm(fwd_sm(u, theta, grid4), theta, grid4)
        return 2 * _la.norm(back) / (_la.norm(u) + 1e-32)

    if raw:
        return fwd_sm, adj_sm, cost_raw, grad_raw, step_raw

    return (
        jax.jit(fwd_sm),
        jax.jit(adj_sm),
        jax.jit(cost_raw),
        jax.jit(grad_raw),
        jax.jit(step_raw),
    )


def sharded_bucket_ops_2d(
    cfg: BucketConfig, mesh, data_axis: str, vol_axis: str,
    raw: bool = False,
):
    """(data x volume) 2D model parallelism for the Bucket operator.

    The reference runs ``num_gpu / obj_split`` DATA groups, each holding a
    theta-slice of the projections, times ``obj_split`` VOLUME chunks per
    group: partial projections are Allreduced within each data group
    (`upstream/src/tike/lamino/solvers/bucket.py:111-114` —
    ``comm.Allreduce(fwd_data, obj_split)``) and gradients are reduced with
    stride ``obj_split`` across data groups (`bucket.py:145-149` —
    ``reduce_gpu(grad_list, stride=obj_split)``). On a 2D mesh both
    hand-written reductions are one ``psum`` each:

    - ``psum(partial projections, vol_axis)`` — within a data group;
    - ``psum(owner-local gradients, data_axis)`` — across data groups.

    Arrays: theta/data sharded on ``data_axis`` (their axis 0), volume/grid
    sharded on ``vol_axis`` (x-slabs, axis 0). Returns
    ``(fwd, adj, cost_op, grad_op, step_scale_op)`` mirroring
    :func:`sharded_bucket_ops`; scalar outputs are replicated.
    """
    from jax.sharding import PartitionSpec as P

    ntheta_factor = mesh.shape[data_axis]

    def _fwd_local(u, theta, grid4):
        part = bucket_fwd(cfg, u.reshape(-1), theta, grid4.reshape(-1, 3))
        return jax.lax.psum(part, vol_axis)  # full projections, local thetas

    def _adj_local(diff, theta, grid4):
        g = bucket_adj(cfg, diff, theta, grid4.reshape(-1, 3))
        # Sum the per-data-group partial gradients of MY voxels.
        return jax.lax.psum(g, data_axis).reshape(grid4.shape[:3])

    def _grad_local(data, u, theta, grid4):
        fd = _fwd_local(u, theta, grid4)
        g = _adj_local(fd - data, theta, grid4)
        ntheta_global = data.shape[-3] * ntheta_factor
        return g / (ntheta_global * cfg.n**3)

    def _cost_local(data, u, theta, grid4):
        diff = _fwd_local(u, theta, grid4) - data
        return jax.lax.psum(
            jnp.sum((diff * jnp.conj(diff)).real), data_axis
        )

    def _sumsq_vol(x):
        """Global |x|^2 of a vol_axis-sharded array (replicated over data)."""
        return jax.lax.psum(jnp.sum((x * jnp.conj(x)).real), vol_axis)

    def _step_scale_local(u, theta, grid4):
        fd = _fwd_local(u, theta, grid4)
        back = _adj_local(fd, theta, grid4)
        un = jnp.sqrt(_sumsq_vol(u))
        return 2 * jnp.sqrt(_sumsq_vol(back)) / (un + 1e-32)

    data_spec = P(data_axis)
    vol_spec = P(vol_axis)

    def _sm(fn, in_specs, out_specs):
        # check_vma=False for the same reason as sharded_bucket_ops: the
        # scatter scan's unvarying zero carry trips the varying-axis check.
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

    fwd_sm = _sm(_fwd_local, (vol_spec, data_spec, vol_spec), data_spec)
    adj_sm = _sm(_adj_local, (data_spec, data_spec, vol_spec), vol_spec)
    cost_sm = _sm(
        _cost_local, (data_spec, vol_spec, data_spec, vol_spec), P()
    )
    grad_sm = _sm(
        _grad_local, (data_spec, vol_spec, data_spec, vol_spec), vol_spec
    )
    step_sm = _sm(
        _step_scale_local, (vol_spec, data_spec, vol_spec), P()
    )

    if raw:
        return fwd_sm, adj_sm, cost_sm, grad_sm, step_sm

    return (
        jax.jit(fwd_sm),
        jax.jit(adj_sm),
        jax.jit(cost_sm),
        jax.jit(grad_sm),
        jax.jit(step_sm),
    )


def bucket_cost(data, fwd_data):
    """Least-squares cost (`bucket.py:252-254`)."""
    diff = fwd_data - data
    return jnp.sum((diff * jnp.conj(diff)).real)


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_grad(cfg: BucketConfig, data, theta, fwd_data, grid):
    """Least-squares gradient (`bucket.py:256-265`)."""
    out = bucket_adj(cfg, fwd_data - data, theta, grid)
    return out / (data.shape[-3] * cfg.n**3)


# ---------------------------------------------------------------------------
# Single-device program surface. The solver composes cost/grad/step-scale
# as ONE program each so intermediates never leave the device.
# ---------------------------------------------------------------------------

bucket_fwd_p = jax.jit(bucket_fwd, static_argnames=("cfg",))
bucket_adj_p = jax.jit(bucket_adj, static_argnames=("cfg",))


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_cost_program(cfg: BucketConfig, data, u, theta, grid):
    """cost(data, fwd(u)) as one program."""
    return bucket_cost(data, bucket_fwd(cfg, u, theta, grid))


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_grad_program(cfg: BucketConfig, data, u, theta, grid):
    """Least-squares gradient of the bucket model, one program."""
    fwd_data = bucket_fwd(cfg, u, theta, grid)
    out = bucket_adj(cfg, fwd_data - data, theta, grid)
    return out / (data.shape[-3] * cfg.n**3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def bucket_step_scale(cfg: BucketConfig, u, theta, grid):
    """CG step-length scale 2|A*A u| / |u| as one program."""
    import tike_tpu.linalg as _la

    back = bucket_adj(cfg, bucket_fwd(cfg, u, theta, grid), theta, grid)
    return 2 * _la.norm(back) / (_la.norm(u) + 1e-32)
