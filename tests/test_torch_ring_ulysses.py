"""Ring and Ulysses attention across ranks against the JAX package, on
the CPU (mirrors JAX ``tests/test_attention.py:56-110,282-460``).

The port's ranks are gloo processes (``parallel/launch.py``,
``tests/torch_multirank_workers.attention``), one group of 2 ranks and
one of 4, each launched once. Every case holds the output and the
gradients of q, k and v of the global loss ``sum(out * g)`` within 1e-5
of JAX's attention over the whole sequence (``_reference_attention``,
what JAX's ring and Ulysses tests hold them to), and Ulysses over "sp4"
also of JAX's Ulysses on its virtual devices, from the same inputs:

- the plain ring and the flash ring's route (``use_flash=True``: each
  resident block through ``flash_attention_with_lse``, whose plain
  version runs on the CPU), causal and not, over "sp2", "sp4" and
  "dp2,sp2" (the batch over ``data`` too);
- Ulysses over "sp2" and "sp4", its attention the einsum chain or the
  flash route;
- the ``flash_block=128`` call JAX makes, which must not raise (the
  port's kernel has one tile a head dim), and ``use_flash=None``;
- Ulysses refuses heads that do not divide over the axis.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
B, S, H, D = 2, 64, 4, 8
CASES = [(kind, strat, causal, flash)
         for kind, strat in (("ring", "sp2"), ("ring", "sp4"),
                             ("ring", "dp2,sp2"), ("ulysses", "sp2"),
                             ("ulysses", "sp4"))
         for causal in (False, True) for flash in (False, True)]


def _name(kind, strat, causal, flash):
    return f"{kind}-{strat}-{'causal' if causal else 'full'}-" \
        f"{'flash' if flash else 'plain'}"


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    return (q, k, v), g


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's attention (``_reference_attention``, what JAX's own ring and
    Ulysses tests hold them to) and its gradients over the whole
    sequence, causal and not; and JAX's Ulysses over "sp4" on its virtual
    devices, causal, as one direct cross-check (JAX's eager ring takes
    about 20 s a case on this CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from analytics_zoo_tpu.ops.attention import _reference_attention
    from analytics_zoo_tpu.ops.ulysses import ulysses_attention
    from analytics_zoo_tpu.parallel.strategy import ShardingStrategy
    (q, k, v), g = _inputs()
    out = {}

    def run(fn, args):
        res = np.asarray(fn(*args))
        grads = jax.grad(lambda a, b_, c: (fn(a, b_, c)
                                           * jnp.asarray(g)).sum(),
                         argnums=(0, 1, 2))(*args)
        return res, [np.asarray(t) for t in grads]

    for causal in (False, True):
        out[causal] = run(lambda a, b_, c: _reference_attention(
            a, b_, c, causal=causal), (q, k, v))
    mesh = ShardingStrategy.parse("sp4").build_mesh(
        devices=jax.devices()[:4], set_default=False)
    sh = NamedSharding(mesh, P(None, "seq", None, None))
    out["ulysses-sp4"] = run(lambda a, b_, c: ulysses_attention(
        a, b_, c, mesh=mesh, causal=True, use_flash=False),
        [jax.device_put(a, sh) for a in (q, k, v)])
    return out


@pytest.fixture(scope="module")
def port_runs():
    (q, k, v), g = _inputs()
    groups = {2: [], 4: []}
    for kind, strat, causal, flash in CASES:
        world = 2 if strat == "sp2" else 4
        groups[world].append({
            "name": _name(kind, strat, causal, flash), "kind": kind,
            "strategy": strat, "causal": causal, "use_flash": flash,
            "qkv": [a.tolist() for a in (q, k, v)], "g": g.tolist()})
    # JAX's default flash_block and the auto choice, on the ring
    groups[2].append({"name": "flash_block", "kind": "ring",
                      "strategy": "sp2", "causal": True, "use_flash": None,
                      "flash_block": 128, "qkv": [a.tolist()
                                                  for a in (q, k, v)],
                      "g": g.tolist()})
    out = {}
    for world, cases in groups.items():
        out.update(launch(f"{WORKERS}:attention", world, args=(cases,))[0])
    return out


def _close(got, want):
    want, want_grads = want
    np.testing.assert_allclose(np.asarray(got["out"]), want, rtol=0,
                               atol=1e-5)
    for name, a, b in zip("qkv", got["grads"], want_grads):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("kind, strat, causal, flash", CASES,
                         ids=[_name(*c) for c in CASES])
def test_matches_jax(jax_refs, port_runs, kind, strat, causal, flash):
    _close(port_runs[_name(kind, strat, causal, flash)], jax_refs[causal])


@pytest.mark.parametrize("flash", [False, True])
def test_ulysses_matches_jax_ulysses(jax_refs, port_runs, flash):
    _close(port_runs[_name("ulysses", "sp4", True, flash)],
           jax_refs["ulysses-sp4"])


def test_flash_block_128_does_not_raise(jax_refs, port_runs):
    want, _ = jax_refs[True]
    np.testing.assert_allclose(np.asarray(port_runs["flash_block"]["out"]),
                               want, rtol=0, atol=1e-5)


def test_ulysses_validates_divisibility():
    from analytics_zoo_tpu_torch.ops.ulysses import ulysses_attention
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("cpu")] * 4
    mesh = mesh_lib.DeviceMesh(grid.reshape(4), ("seq",))
    q = torch.zeros((2, 16, 3, 4))
    with pytest.raises(ValueError, match="divide"):
        ulysses_attention(q, q, q, mesh=mesh)
    one = mesh_lib.DeviceMesh(grid[:1].reshape(1), ("seq",))
    with pytest.raises(ValueError, match="usable"):
        ulysses_attention(q, q, q, mesh=one)


def test_one_rank_ring_is_attention():
    """A ring of one rank is the attention itself (no collective)."""
    from analytics_zoo_tpu_torch.ops.attention import _reference_attention
    from analytics_zoo_tpu_torch.ops.ring_attention import ring_attention
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    grid = np.empty(1, dtype=object)
    grid[:] = [torch.device("cpu")]
    mesh = mesh_lib.DeviceMesh(grid.reshape(1), ("seq",))
    (q, k, v), _ = _inputs()
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    for causal in (False, True):
        for flash in (False, True):
            got = ring_attention(q, k, v, mesh=mesh, causal=causal,
                                 use_flash=flash)
            want = _reference_attention(q.double(), k.double(), v.double(),
                                        causal=causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5)
