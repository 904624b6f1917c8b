"""Direct placement/value spec tests for the collective primitives.

Port of the intent of the reference's per-collective ThreadPool tests
(`upstream/tests/communicators/test_pool.py:8-173`): where the
reference asserts explicit expected placement for bcast/gather/scatter/
swap_edges, these tests pin the placement and value rules of the mesh
primitives in `tike_tpu.parallel` — so any change to a placement rule fails
a test here, not just a composed end-to-end equivalence run.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from tike_tpu.parallel import (
    BATCH_AXIS,
    batch_sharding,
    fetch_global,
    make_mesh,
    put_process_local,
    put_replicated_global,
    replicated_sharding,
)
from tike_tpu.parallel.distributed import (
    make_global_batch_data,
    split_for_process,
    stripe_indices,
    striped_batches,
)
from tike_tpu.parallel.halo import _blend_ramp, swap_edges


# ---------------------------------------------------------------------------
# Placement: put_* / batch_sharding (the bcast/scatter analogs)
# ---------------------------------------------------------------------------


def test_put_process_local_divisible_placement():
    """Device d must own exactly rows [d*L/8, (d+1)*L/8) — the contiguous
    block rule every striped program relies on."""
    mesh = make_mesh()
    n = mesh.size
    rows = 4 * n
    block = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    x = put_process_local(block, batch_sharding(mesh), rows)
    assert x.shape == (rows, 3)
    per = rows // n
    shards = sorted(x.addressable_shards, key=lambda s: s.device.id)
    assert len(shards) == n
    for d, shard in enumerate(shards):
        assert shard.index[0] == slice(d * per, (d + 1) * per, None)
        np.testing.assert_array_equal(
            np.asarray(shard.data), block[d * per : (d + 1) * per]
        )


def test_put_process_local_ragged_rows_rejected():
    """The placement contract: row counts must be divisible by the device
    count (callers pad via ``local_multiple`` / ``batches_padded``). A
    ragged block must fail loudly, never silently re-stripe."""
    mesh = make_mesh()
    rows = 4 * mesh.size + 3  # ragged final stripe
    block = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    with pytest.raises(ValueError, match="divisible"):
        put_process_local(block, batch_sharding(mesh), rows)


def test_put_replicated_global_every_device_full_copy():
    """The bcast rule: every device holds the identical full array."""
    mesh = make_mesh()
    host = np.arange(24, dtype=np.float32).reshape(4, 6)
    x = put_replicated_global(host, replicated_sharding(mesh))
    assert len(x.addressable_shards) == mesh.size
    for shard in x.addressable_shards:
        assert shard.data.shape == host.shape
        np.testing.assert_array_equal(np.asarray(shard.data), host)


def test_put_process_local_complex_pair_roundtrip():
    """Complex host data must survive placement + fetch_global exactly."""
    mesh = make_mesh()
    rows = 2 * mesh.size
    rng = np.random.default_rng(0)
    block = (
        rng.standard_normal((rows, 5)) + 1j * rng.standard_normal((rows, 5))
    ).astype(np.complex64)
    x = put_process_local(block, batch_sharding(mesh), rows)
    np.testing.assert_array_equal(fetch_global(x), block)


def test_make_global_batch_data_slot_axis_placement():
    """Slot-axis sharding: contiguous slot blocks per device, values equal
    the local block (single-process: local IS global)."""
    mesh = make_mesh()
    n = mesh.size
    nb, Lp, det = 3, 2 * n, 4
    local = np.arange(nb * Lp * det * det, dtype=np.float32).reshape(
        nb, Lp, det, det
    )
    x = make_global_batch_data(mesh, local, num_processes=1)
    assert x.shape == (nb, Lp, det, det)
    np.testing.assert_array_equal(fetch_global(x), local)
    per = Lp // n
    for shard in x.addressable_shards:
        sl = shard.index[1]
        assert (sl.stop - sl.start) == per  # contiguous slot block


# ---------------------------------------------------------------------------
# stripe layout: stripe_indices / split_for_process / striped_batches
# ---------------------------------------------------------------------------


def test_stripe_indices_equal_count_and_sorted_by_row():
    rng = np.random.default_rng(1)
    scan = rng.uniform(0, 100, (37, 2)).astype(np.float32)
    stripes = stripe_indices(scan, num_processes=4)
    sizes = [len(s) for s in stripes]
    # Equal counts (ragged remainder spread one-per-stripe, largest first).
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == 37
    assert sorted(sizes, reverse=True) == sizes
    # Stripes are ordered by row coordinate: every row in stripe k sits at
    # or below every row in stripe k+1.
    for a, b in zip(stripes[:-1], stripes[1:]):
        assert scan[a, 0].max() <= scan[b, 0].min() + 1e-6
    # Together they are a permutation of all rows.
    assert sorted(np.concatenate(stripes).tolist()) == list(range(37))


def test_split_for_process_matches_array_split():
    a = np.arange(11)
    parts = [
        split_for_process(a, num_processes=3, process_id=r) for r in range(3)
    ]
    np.testing.assert_array_equal(np.concatenate(parts), a)
    expect = np.array_split(a, 3)
    for got, want in zip(parts, expect):
        np.testing.assert_array_equal(got, want)


def _layout(n, num_processes, num_batch, local_multiple, seed=0):
    rng = np.random.default_rng(7)
    scan = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    return scan, striped_batches(
        scan,
        num_processes=num_processes,
        batch_method="wobbly_center",
        num_batch=num_batch,
        rng=np.random.default_rng(seed),
        local_multiple=local_multiple,
    )


@pytest.mark.parametrize(
    "n,procs,nb,mult",
    [
        (64, 4, 3, 2),  # divisible-ish
        (61, 4, 3, 2),  # ragged final stripe
        (13, 8, 2, 1),  # stripes of 1-2 rows, heavy padding
    ],
)
def test_striped_batches_layout_spec(n, procs, nb, mult):
    scan, (global_order, batch_idx, batch_mask, stripe_slots, stripe_start) = (
        _layout(n, procs, nb, mult)
    )
    # global_order is a permutation of all pattern rows.
    assert sorted(global_order.tolist()) == list(range(n))
    Lp = batch_idx.shape[1] // procs
    assert Lp * procs == batch_idx.shape[1]
    assert Lp % mult == 0
    assert batch_idx.shape[0] == nb

    stripe_sizes = [len(s) for s in stripe_indices(scan, procs)]
    offsets = np.cumsum([0] + stripe_sizes)
    seen = []
    for p in range(procs):
        block = batch_idx[:, p * Lp : (p + 1) * Lp]
        mask = batch_mask[:, p * Lp : (p + 1) * Lp]
        # Placement rule: stripe p's slots index only stripe p's rows of
        # the reordered array.
        assert block.min() >= offsets[p] and block.max() < offsets[p + 1]
        # stripe_slots must be exactly the local (offset-free) view.
        np.testing.assert_array_equal(stripe_slots[p][0] + offsets[p], block)
        np.testing.assert_array_equal(stripe_slots[p][1], mask)
        # Padded slots carry mask 0 and a valid in-stripe index; when the
        # batch has real slots they repeat one of them (so jitted steps
        # never touch rows outside the batch).
        for b in range(nb):
            off = mask[b] > 0
            seen.extend(block[b][off].tolist())
            pad = block[b][~off]
            if pad.size and off.any():
                assert set(pad.tolist()) <= set(block[b][off].tolist())
    # Across all batches the masked-on slots partition every row exactly once.
    assert sorted(seen) == list(range(n))


def test_striped_batches_deterministic_across_ranks():
    """Identically-seeded calls (what every process does) must agree."""
    _, a = _layout(61, 4, 3, 2, seed=3)
    _, b = _layout(61, 4, 3, 2, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    for (ia, ma), (ib, mb) in zip(a[3], b[3]):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)


# ---------------------------------------------------------------------------
# swap_edges: exact blend values + edge cases
# ---------------------------------------------------------------------------


def _swap_edges_numpy(psi, ndev, overlap):
    """Independent numpy model of the seam cross-fade."""
    d, h, w = psi.shape
    rows = h // ndev
    out = psi.copy()
    ramp = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1][
        None, :, None
    ]
    for i in range(ndev):
        lo, hi = i * rows, (i + 1) * rows
        if i > 0:
            above_bot = psi[:, lo - overlap : lo, :]
            mine = psi[:, lo : lo + overlap, :]
            out[:, lo : lo + overlap, :] = (1 - ramp) * above_bot + ramp * mine
        if i < ndev - 1:
            below_top = psi[:, hi : hi + overlap, :]
            mine = psi[:, hi - overlap : hi, :]
            rr = ramp[:, ::-1, :]
            out[:, hi - overlap : hi, :] = (1 - rr) * below_top + rr * mine
    return out


@pytest.mark.parametrize("overlap", [1, 3])
def test_swap_edges_exact_blend_values(overlap):
    mesh = make_mesh()
    ndev = mesh.size
    rng = np.random.default_rng(5)
    psi = (
        rng.standard_normal((2, 8 * ndev, 16))
        + 1j * rng.standard_normal((2, 8 * ndev, 16))
    ).astype(np.complex64)
    sharded = jax.device_put(
        psi, NamedSharding(mesh, P(None, BATCH_AXIS, None))
    )
    out = np.asarray(jax.device_get(swap_edges(sharded, mesh, overlap)))
    np.testing.assert_allclose(
        out, _swap_edges_numpy(psi, ndev, overlap), rtol=1e-6, atol=1e-6
    )
    # Outer boundary rows (top of stripe 0, bottom of last) are untouched.
    np.testing.assert_array_equal(out[:, :overlap, :], psi[:, :overlap, :])
    np.testing.assert_array_equal(out[:, -overlap:, :], psi[:, -overlap:, :])


def test_swap_edges_overlap_zero_is_identity():
    mesh = make_mesh()
    psi = np.ones((1, 8 * mesh.size, 8), np.complex64)
    out = swap_edges(jax.device_put(
        psi, NamedSharding(mesh, P(None, BATCH_AXIS, None))
    ), mesh, 0)
    np.testing.assert_array_equal(np.asarray(jax.device_get(out)), psi)


def test_swap_edges_height_not_divisible_raises():
    """shard_map cannot stripe a non-divisible height — must fail loudly,
    not wrap around silently."""
    mesh = make_mesh()
    h = 8 * mesh.size + 4
    psi = jnp_ones = np.ones((1, h, 8), np.complex64)
    del jnp_ones
    with pytest.raises(Exception):
        swap_edges(
            jax.device_put(
                psi, NamedSharding(mesh, P(None, BATCH_AXIS, None))
            ),
            mesh,
            2,
        )


def test_swap_edges_halo_wider_than_stripe_raises():
    """overlap > stripe height would double-count interior rows; the
    implementation must reject it rather than corrupt the seam."""
    mesh = make_mesh()
    rows = 4
    psi = np.ones((1, rows * mesh.size, 8), np.complex64)
    with pytest.raises(Exception):
        jax.block_until_ready(
            swap_edges(
                jax.device_put(
                    psi, NamedSharding(mesh, P(None, BATCH_AXIS, None))
                ),
                mesh,
                rows + 1,
            )
        )
