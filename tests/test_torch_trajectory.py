"""FHDP loss trajectories of the port and the reference on the CPU at the
Session's learning rate, 1e-3: both packages start from the same params
(the port's init from a seed, bridged to the reference) and take the
same numpy batches, one fresh batch a step, on a (2, 4) mesh (the
reference on 8 forced host devices), 2 sequences a rank.

The tests run reduced flad-vision; the tolerances are the step tests'
(``tests/test_torch_pipeline.py``): each loss within relative 1e-5 of
the reference's at the first step, 1e-4 after (the near-eps params of
the earlier steps move the later losses by up to a few 1e-5 relative).

Run as a script it prints both trajectories at full width (12 layers,
d_model 768, float32; about 3 GiB and a few minutes of CPU time), four
steps on fresh batches and eight on one batch repeated (the reference's
own descent check, ``tests/test_pipeline.py``)::

    PYTHONPATH=src python tests/test_torch_trajectory.py --full
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8"
                               ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.common import reduced as jax_reduced  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api.mesh import MeshSpec  # noqa: E402
from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.fhdp import init_fhdp  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402

LR = 1e-3              # the Session's default
BATCH = 16             # 2 sequences a rank of the (2, 4) mesh
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-4


def numpy_batches(cfg, n, seed):
    """``n`` vision batches of BATCH samples from ``seed``."""
    rng = np.random.default_rng(seed)
    p, f = cfg.prefix_tokens, cfg.prefix_dim
    out = []
    for _ in range(n):
        out.append({
            "rgb": rng.standard_normal((BATCH, p, f)).astype(np.float32),
            "lidar": rng.standard_normal((BATCH, p, f)).astype(np.float32),
            "waypoints": rng.standard_normal(
                (BATCH, cfg.num_waypoints, 2)).astype(np.float32),
            "light": rng.integers(0, cfg.num_light_classes, (BATCH,))
            .astype(np.int32)})
    return out


def configs(full):
    """(port config, reference config): flad-vision, reduced unless
    ``full``."""
    cfg, jcfg = get_config("flad-vision"), jax_config("flad_vision")
    return (cfg, jcfg) if full else (reduced(cfg), jax_reduced(jcfg))


def reference_step(jmesh, full=False):
    """The reference's jitted FHDP step at lr LR on ``jmesh``."""
    jcfg = configs(full)[1]
    step, _ = jpl.make_fhdp_train_step(
        jcfg, JShape("t", 1, BATCH, "train"), jmesh, learning_rate=LR)
    return jax.jit(step)


def trajectories(jstep, batches, *, full=False, seed=0):
    """(reference losses, port losses) of len(batches) FHDP steps from
    the port's init with ``seed``, bridged to the reference's jitted step
    ``jstep`` (:func:`reference_step`)."""
    cfg = configs(full)[0]
    mesh = MeshSpec((2, 4)).build("cpu")
    pp, opt, tmpl = init_fhdp(cfg, mesh, seed)
    jpp = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(pp))
    jopt = jax.tree.map(jnp.asarray, bridge.zero2_to_numpy(opt, 2))
    want = []
    for b in batches:
        jpp, jopt, m = jstep(jpp, jopt, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        want.append(float(m["loss"]))
    del jpp, jopt

    step, _ = pl.make_fhdp_train_step(
        cfg, ShapeConfig("t", 1, BATCH, "train"), mesh, learning_rate=LR,
        templates=tmpl)
    got = []
    for b in batches:
        pp, opt, m = step(pp, opt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        got.append(float(m["loss"]))
    return want, got


def assert_same_trajectory(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        tol = FIRST_RTOL if i == 0 else LATER_RTOL
        assert abs(g - w) <= tol * abs(w), (i, got, want)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstep(mesh24):
    return reference_step(mesh24)


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["fresh", "one-batch"])
def test_trajectory_matches_reference_at_session_lr(repeat, jstep):
    cfg = configs(False)[0]
    batches = numpy_batches(cfg, 1 if repeat else 4, 31)
    want, got = trajectories(jstep, batches * 4 if repeat else batches)
    assert_same_trajectory(want, got)


def main(argv):
    full = "--full" in argv
    from repro.launch.mesh import make_test_mesh
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(os.cpu_count() or 1)
    jstep = reference_step(make_test_mesh(data=2, model=4), full)
    cfg = configs(full)[0]
    width = f"{cfg.num_layers} layers, d_model {cfg.d_model}"
    for label, batches in (
            ("4 steps, a fresh batch each", numpy_batches(cfg, 4, 31)),
            ("8 steps on one batch", numpy_batches(cfg, 1, 32) * 8)):
        want, got = trajectories(jstep, batches, full=full)
        print(f"[trajectory] flad-vision ({width}), lr {LR}, {label}:")
        print("  reference: " + ", ".join(f"{x:.6f}" for x in want))
        print("  port:      " + ", ".join(f"{x:.6f}" for x in got))
        print("  max |port - reference| / |reference|: "
              f"{max(abs(g - w) / abs(w) for g, w in zip(got, want)):.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
