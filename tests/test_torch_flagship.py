"""The flagship step and its multi-device dry run
(cleisthenes_tpu_torch/flagship.py) against the reference's
``__graft_entry__.py``: the step's (roots, encoded) byte-equal to the
reference's ``_flagship`` step jitted on the JAX CPU, and the dry run
over eight handles of the CPU (the kernels' plain versions) at a small
roster, equal to the unsharded step."""

import numpy as np
import pytest
import torch

from cleisthenes_tpu_torch.flagship import (
    dryrun_multichip,
    entry,
    flagship,
    mesh_dims,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,f,length", [(8, 2, 256), (16, 5, 130), (64, 21, 512)])
def test_flagship_step_matches_reference(n, f, length):
    import jax

    from __graft_entry__ import _flagship

    ref_step, (ref_data,) = _flagship(n=n, f=f, length=length)
    ref_roots, ref_encoded = jax.jit(ref_step)(ref_data)
    step, (data,) = flagship(n, f, length, device="cpu")
    np.testing.assert_array_equal(data.numpy(), np.asarray(ref_data))
    roots, encoded = step(data)
    assert roots.shape == (n, 32) and encoded.shape == (n, n, length)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(ref_roots))
    np.testing.assert_array_equal(encoded.numpy(), np.asarray(ref_encoded))


def test_entry_is_the_reference_roster():
    step, (data,) = entry(device="cpu")
    assert tuple(data.shape) == (8, 4, 256)
    roots, encoded = step(data)
    assert tuple(encoded.shape) == (8, 8, 256)


def test_mesh_dims_follow_the_reference():
    assert [mesh_dims(d) for d in (1, 2, 4, 6, 8)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4),
    ]


@pytest.mark.parametrize("n_devices", [8, 1])
def test_dryrun_multichip_on_cpu_handles(n_devices, capsys):
    """The dry run over CPU handles at a small roster: its shapes, its
    roots and shards equal the unsharded step at its length, and the
    lockstep epoch on the sharded plane commits every tx."""
    n, f, batch = 8, 2, 16
    out = dryrun_multichip(n_devices, devices=[CPU] * n_devices, n=n, f=f, batch=batch)
    v, l = mesh_dims(n_devices)
    length = max(512, 64 * l)
    assert out["mesh"] == (v, l)
    assert out["in_tile_shape"] == (n // v, n - 2 * f, length // l)
    assert out["out_block_shape"] == (n // v, n, length)
    step, (data,) = flagship(n, f, length, device="cpu")
    roots, encoded = step(data)
    np.testing.assert_array_equal(out["roots"], roots.numpy())
    np.testing.assert_array_equal(out["encoded"], encoded.numpy())
    assert out["checksum"] == int(roots.to(torch.int64).sum())
    assert sum(len(b) for b in out["batches"]) == batch
    assert "dryrun_multichip ok" in capsys.readouterr().out


def test_dryrun_multichip_defaults_to_the_cards():
    if torch.cuda.device_count() >= 8:
        pytest.skip("this machine has eight cards: the default runs there")
    with pytest.raises(ValueError, match="needs 8 cards"):
        dryrun_multichip(8)
