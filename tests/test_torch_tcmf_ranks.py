"""TCMF's series across ranks in the port against its one-rank fit and
the JAX package's sharded fit, on the CPU (mirrors JAX ``tests/
test_zouwu.py::test_mesh_sharded_10k_series``'s distributed check).

``distributed=True`` under a process group blocks Y and F by rows over
the ranks, keeps X replicated and sums its gradient (``zouwu/model/
tcmf.py``). The ranks are gloo processes (``parallel/launch.py``, the
rank function ``tests/torch_multirank_workers.tcmf_fit``, no JAX), a
group of 2 and one of 4, each launched once for the module. Every fit
starts from JAX's ``_init_factors`` (its threefry draws), carried over:

- over 2 and 4 ranks, 64 series (dividing) and 37 (not: the first ranks
  hold one row more): ``devices_used`` is the ranks, and the forecast
  within JAX's ``rtol=atol=0.05`` of the port's one-rank fit;
- 64 series against JAX's ``distributed=True`` fit on its 8 virtual
  devices (37 does not divide over JAX's 8), at the same tolerance.

The sums run in another order, so the routes are rounding apart: F, X
and the forecast read within 1e-6 of the one-rank fit and the forecast
within 1e-6 of JAX's (the distances are in the assertion messages), so
each is also held within 1e-4, the mse within 1e-4 relative. X's terms
counted once a rank, X's gradient left unsummed or the mse divided by a
rank's own count each move F or X by 0.01 or more here.
"""

import numpy as np
import os
import pytest

from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
STEPS, T = 300, 96
SERIES = (64, 37)
ROUTES = 1e-4       # two fp32 routes' distance (about 1e-6), with room


def _panel(n, t_total, seed=0, k_true=3):
    """JAX ``TestTCMF._panel``."""
    rng = np.random.RandomState(seed)
    t = np.arange(t_total)
    basis = np.stack([np.sin(t * 2 * np.pi / 24),
                      np.cos(t * 2 * np.pi / 24), 0.01 * t])[:k_true]
    F = rng.normal(size=(n, k_true))
    return (F @ basis + rng.normal(0, 0.01, (n, t_total))).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's start for each panel, and its sharded fit of the 64."""
    pytest.importorskip("jax")
    from analytics_zoo_tpu.common import context as jctx
    from analytics_zoo_tpu.zouwu.model.tcmf import TCMFForecaster
    out = {}
    jctx.stop_orca_context()
    jctx.init_orca_context(cluster_mode="local")
    try:
        for n in SERIES:
            y = _panel(n, 120, seed=3)[:, :T]
            m = TCMFForecaster(k=4, ar_order=24, lr=0.05)
            f0, x0 = m._init_factors(y)
            out[n] = {"y": y, "f0": np.asarray(f0, np.float32),
                      "x0": np.asarray(x0, np.float32)}
            if n % 8 == 0:
                mse = m.fit(y, num_steps=STEPS, distributed=True)
                assert m.fit_report["devices_used"] == 8
                out[n].update(mse=mse, pred=np.asarray(m.predict(8)))
    finally:
        jctx.stop_orca_context()
    return out


@pytest.fixture(scope="module")
def one_rank(jax_side):
    """The port's one-rank fit of each panel from JAX's start."""
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    out = {}
    for n in SERIES:
        s = jax_side[n]
        m = TCMFForecaster(k=4, ar_order=24, lr=0.05, device="cpu")
        m._init_factors = lambda _y, s=s: (s["f0"].copy(), s["x0"].copy())
        mse = m.fit(s["y"], num_steps=STEPS, distributed=False)
        out[n] = {"mse": mse, "pred": m.predict(8), "F": m.F, "X": m.X}
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    cases = [{"name": str(n), "y": jax_side[n]["y"].tolist(),
              "f0": jax_side[n]["f0"].tolist(),
              "x0": jax_side[n]["x0"].tolist(), "steps": STEPS}
             for n in SERIES]
    return {w: launch(f"{WORKERS}:tcmf_group", w, args=(cases,),
                      timeout=600) for w in (2, 4)}


def _dist(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", SERIES)
def test_sharded_fit_matches_one_rank(ranks, one_rank, world, n):
    results = [r[str(n)] for r in ranks[world]]
    first = results[0]
    for r in results:
        assert r["report"]["devices_used"] == world
        assert r["report"]["sharded"] is True
        assert r["report"]["n_series"] == n
        # every rank ends with the whole factors, the same bits
        assert r["F"] == first["F"] and r["X"] == first["X"]
        assert r["mse"] == first["mse"]
    want = one_rank[n]
    msg = (f"{world} ranks, {n} series: F {_dist(first['F'], want['F']):.3g}"
           f", X {_dist(first['X'], want['X']):.3g}, forecast "
           f"{_dist(first['pred'], want['pred']):.3g} from the one-rank "
           f"fit; mse {first['mse']:.6g} vs {want['mse']:.6g}")
    print(msg)
    assert np.asarray(first["F"]).shape == (n, 4), msg
    np.testing.assert_allclose(first["pred"], want["pred"], rtol=0.05,
                               atol=0.05, err_msg=msg)
    assert abs(first["mse"] - want["mse"]) <= 0.05 * max(want["mse"], 1e-3)
    for key in ("F", "X", "pred"):
        assert _dist(first[key], want[key]) <= ROUTES, msg
    assert abs(first["mse"] - want["mse"]) <= ROUTES * want["mse"], msg


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fit_matches_jax(ranks, jax_side, world):
    first = ranks[world][0]["64"]
    want = jax_side[64]
    msg = (f"{world} ranks against JAX's 8 devices: forecast "
           f"{_dist(first['pred'], want['pred']):.3g}, mse "
           f"{first['mse']:.6g} vs {want['mse']:.6g}")
    print(msg)
    np.testing.assert_allclose(first["pred"], want["pred"], rtol=0.05,
                               atol=0.05, err_msg=msg)
    assert first["mse"] < 0.1, msg
    assert _dist(first["pred"], want["pred"]) <= ROUTES, msg
    assert abs(first["mse"] - want["mse"]) <= ROUTES * want["mse"], msg
