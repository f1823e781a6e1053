"""The port's copies of the JAX package's numpy-only sim modules
(evfly_tpu_torch/sim/{obstacles,expert,evaluator,rigid_body,planner,
betaflight_llc}.py) against the originals: the same code under a docstring
that names the original, and the same results bit for bit on the same
seeds."""

import ast
import pathlib

import numpy as np
import pytest

from evfly_tpu.sim import betaflight_llc as j_bf
from evfly_tpu.sim import evaluator as j_ev
from evfly_tpu.sim import expert as j_ex
from evfly_tpu.sim import obstacles as j_ob
from evfly_tpu.sim import planner as j_pl
from evfly_tpu.sim import rigid_body as j_rb
from evfly_tpu_torch.sim import betaflight_llc as t_bf
from evfly_tpu_torch.sim import evaluator as t_ev
from evfly_tpu_torch.sim import expert as t_ex
from evfly_tpu_torch.sim import obstacles as t_ob
from evfly_tpu_torch.sim import planner as t_pl
from evfly_tpu_torch.sim import rigid_body as t_rb

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["obstacles", "expert", "evaluator", "rigid_body", "planner", "betaflight_llc"]


def _code(path):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(path.read_text())
    return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))


@pytest.mark.parametrize("name", COPIES)
def test_copy_keeps_the_code(name):
    port = REPO / "evfly_tpu_torch" / "sim" / f"{name}.py"
    assert _code(port) == _code(REPO / "evfly_tpu" / "sim" / f"{name}.py")
    assert f"A copy of ``evfly_tpu/sim/{name}.py``" in ast.get_docstring(ast.parse(
        port.read_text()))


def _forests(mod, seed, trees):
    rng = np.random.default_rng(seed)
    return [mod.generate_forest(rng, num_obstacles=30, trees=trees) for _ in range(3)]


@pytest.mark.parametrize("trees", [True, False])
def test_generate_forest_and_csv_round_trip(tmp_path, trees):
    for fj, ft in zip(_forests(j_ob, 3, trees), _forests(t_ob, 3, trees)):
        np.testing.assert_array_equal(fj.positions, ft.positions)
        np.testing.assert_array_equal(fj.radii, ft.radii)
        assert fj.is_trees == ft.is_trees
        t_ob.save_obstacle_csv(tmp_path / "port.csv", ft)
        j_ob.save_obstacle_csv(tmp_path / "jax.csv", fj)
        assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
        back = j_ob.load_obstacle_csv(str(tmp_path / "port.csv"))
        back_t = t_ob.load_obstacle_csv(str(tmp_path / "jax.csv"))
        np.testing.assert_array_equal(back.positions, back_t.positions)
        np.testing.assert_array_equal(back.radii, back_t.radii)
        assert back.is_trees == back_t.is_trees == trees
        pos = np.array([10.0, 1.0, 2.0])
        assert ft.nearest_margin(pos, 0.2) == fj.nearest_margin(pos, 0.2)


@pytest.mark.parametrize("trees", [True, False])
def test_expert_commands_equal(trees):
    fj, ft = _forests(j_ob, 5, trees)[0], _forests(t_ob, 5, trees)[0]
    rng_j, rng_t, rng_p = (np.random.default_rng(9) for _ in range(3))
    for _ in range(40):
        pos = np.array([rng_p.uniform(0, 55), rng_p.uniform(-4, 4), rng_p.uniform(0.5, 4)])
        vj, ej = j_ex.expert_velocity_command(pos, fj, 4.0, rng_j)
        vt, et = t_ex.expert_velocity_command(pos, ft, 4.0, rng_t)
        np.testing.assert_array_equal(vj, vt)
        assert ej.keys() == et.keys()


def test_trial_evaluator_equal(tmp_path):
    fj, ft = _forests(j_ob, 7, True)[0], _forests(t_ob, 7, True)[0]
    ej, et = j_ev.TrialEvaluator(), t_ev.TrialEvaluator()
    ej.reset()
    et.reset()
    rng = np.random.default_rng(2)
    pos = np.array([0.0, 0.0, 2.0])
    for i in range(3000):
        pos = pos + np.array([0.02, rng.normal(0, 0.02), rng.normal(0, 0.005)])
        aj = ej.update(i * 0.01, pos, fj)
        at = et.update(i * 0.01, pos, ft)
        assert aj == at
        if not aj:
            break
    assert ej.summary() == et.summary()
    np.testing.assert_array_equal(np.array(ej.pos_log), np.array(et.pos_log))
    np.testing.assert_array_equal(np.array(ej.margin_log), np.array(et.margin_log))


def test_rigid_body_quads_equal():
    qj, qt = j_rb.RigidBodyQuad(), t_rb.RigidBodyQuad()
    vj, vt = j_rb.VecRigidBodyQuads(3), t_rb.VecRigidBodyQuads(3)
    rng = np.random.default_rng(4)
    for step in range(300):
        if step % 10 == 0:
            cmd = rng.normal(size=3) * 2
            cmds = rng.normal(size=(3, 3)) * 2
            qj.set_velocity_command(cmd)
            qt.set_velocity_command(cmd)
            mask = rng.random(3) < 0.7
            vj.set_commands(cmds, mask)
            vt.set_commands(cmds, mask)
        sj, st = qj.step(0.01), qt.step(0.01)
        for a in ("pos", "vel", "att"):
            np.testing.assert_array_equal(getattr(sj, a), getattr(st, a))
        for a, b in zip(vj.step(0.01), vt.step(0.01)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(vj.q, vt.q)
    np.testing.assert_array_equal(j_rb.QuadrotorParams().allocation,
                                  t_rb.QuadrotorParams().allocation)


def test_planner_expert_equal():
    fj, ft = _forests(j_ob, 11, True)[0], _forests(t_ob, 11, True)[0]
    pj, pt = j_pl.PlannerExpert(fj, 4.0), t_pl.PlannerExpert(ft, 4.0)
    np.testing.assert_array_equal(pj.ts, pt.ts)
    rng = np.random.default_rng(1)
    for i in range(50):
        pos = np.array([i * 0.8, rng.uniform(-2, 2), rng.uniform(0.5, 3)])
        np.testing.assert_array_equal(pj.velocity_at(i * 0.2, pos), pt.velocity_at(i * 0.2, pos))
    gj, gt = j_pl.Planner(), t_pl.Planner()
    gj.fill_from_field(fj)
    gt.fill_from_field(ft)
    start, end = np.array([0.0, 0.0, 2.0]), np.array([60.0, 0.0, 2.0])
    np.testing.assert_array_equal(gj.find_path(start, end), gt.find_path(start, end))


def test_betaflight_llc_equal():
    lj, lt = j_bf.BetaflightLLC(), t_bf.BetaflightLLC()
    rng = np.random.default_rng(6)
    for i in range(400):
        if i % 25 == 0:
            c, om = rng.uniform(0, 30), rng.normal(size=3) * 3
            lj.set_command(c, om)
            lt.set_command(c, om)
        meas = rng.normal(size=3)
        np.testing.assert_array_equal(lj.run(meas), lt.run(meas))
