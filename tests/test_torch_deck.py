"""The port's deck runner (``spherharm_tpu_torch/io/deck.py``) against the
JAX package's (``spherharm_tpu/io/deck.py``), on the CPU.

- Every ``examples/*.in`` deck creates bit-identical atoms in both runners
  (the parser and its numpy draws are the reference's).
- Cuts of ``two_body.in``, ``shear_cell.in``, ``two_materials.in`` (the
  Lmax-8 case) and ``settling.in`` run in both: thermo rows at rtol 2e-3,
  positions at 1e-3, dump frames with the same ids (tolerances of
  tests/test_torch_drum.py). The reference runs with ``exact_eval=True``:
  on the CPU it otherwise takes its interp-table radius, ~1 % off the
  exact surface the port always evaluates.
- tests/test_io.py's deck tests, mirrored one for one on the port (the
  long collisions of the group-velocity and freeze tests start closer
  so they land in fewer steps), and a JAX deck's restart resumed in the
  port's deck.
"""

import functools
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spherharm_tpu.core.simulation import Simulation as JaxSimulation
from spherharm_tpu.io import deck as jdeck
from spherharm_tpu_torch.io import deck as tdeck
from spherharm_tpu_torch.io.deck import (
    BlockRegion, CylinderRegion, DeckRunner as _DeckRunner, PrismRegion,
    SphereRegion,
)
from spherharm_tpu_torch.io.dump import read_dump

from torch_port_util import (
    EXAMPLES, by_tag, compare_deck_runs, cut_deck, deck_setup_and_rest, np32,
)

ROOT = Path(__file__).resolve().parents[1]
DeckRunner = functools.partial(_DeckRunner, device="cpu")


@pytest.fixture
def jax_exact(monkeypatch):
    """The reference's runner with the exact surface evaluation."""
    monkeypatch.setattr(jdeck, "Simulation",
                        functools.partial(JaxSimulation, exact_eval=True))


def _run_both(text, tmp_path):
    """Run ``text`` in both runners (dumps into separate directories);
    atoms bit-identical before the first run. Returns (jax, port)."""
    runners = []
    for sub, make in (("jax", jdeck.DeckRunner), ("port", DeckRunner)):
        (tmp_path / sub).mkdir(exist_ok=True)
        setup, rest = deck_setup_and_rest(text.replace(str(tmp_path),
                                                   str(tmp_path / sub)))
        r = make()
        r.run_text(setup)
        runners.append((r, rest))
    (j, jrest), (t, trest) = runners
    assert sorted(j.atoms) == sorted(t.atoms)
    for k in j.atoms:
        np.testing.assert_array_equal(t.atoms[k], j.atoms[k], err_msg=k)
    j.run_text(jrest)
    t.run_text(trest)
    return j, t


def _compare(j, t, keys=("etot", "ke", "pe_pair")):
    err = compare_deck_runs(j, t, keys)
    assert err["ok"], err
    assert int(t.neigh.overflow) == int(j.neigh.overflow) == 0


# -- parity with the reference's runner -----------------------------------


def test_runners_have_the_same_commands():
    """The grammar is copied, not shared: both runners handle the same
    command set."""
    cmds = lambda cls: {n for n in dir(cls) if n.startswith("cmd_")}
    assert cmds(_DeckRunner) == cmds(jdeck.DeckRunner)
    assert len(cmds(_DeckRunner)) >= 30


# The runner's device layer, which the port rewrites; every other member
# is the reference's copy.
REWRITTEN = {"__init__", "_build_shapes", "_materialize", "_outputs",
             "cmd_read_restart", "cmd_run", "cmd_write_restart"}
COPIED = ["DeckError", "Region", "BlockRegion", "SphereRegion", "CylinderRegion",
          "PrismRegion"] + sorted(
    f"DeckRunner.{n}" for n, v in vars(jdeck.DeckRunner).items()
    if inspect.isfunction(v) and n not in REWRITTEN)


def _source(module, member):
    """A member's source, less the two edits the copy makes: the computes
    module is imported at the top of the port's file, and walls are built
    on the runner's device."""
    obj = module
    for part in member.split("."):
        obj = getattr(obj, part)
    return inspect.getsource(obj).replace(
        "        from spherharm_tpu.core import computes as computes_mod\n\n", "").replace(
        "mat=mat, device=self.device,", "mat=mat,")


@pytest.mark.parametrize("member", COPIED)
def test_copied_parser_matches_reference(member):
    """The parser, regions, substitution, expression evaluator and every
    command handler outside the device layer are the reference's source,
    line for line."""
    assert _source(tdeck, member) == _source(jdeck, member)


def test_copied_members_are_all_of_the_runner():
    """The port's runner has no member of its own outside the device
    layer, and its lattice table is the reference's."""
    funcs = lambda cls: {n for n, v in vars(cls).items() if inspect.isfunction(v)}
    assert funcs(_DeckRunner) - REWRITTEN == funcs(jdeck.DeckRunner) - REWRITTEN
    assert REWRITTEN <= funcs(_DeckRunner)
    assert tdeck._LATTICE_BASIS.keys() == jdeck._LATTICE_BASIS.keys()
    for k, v in jdeck._LATTICE_BASIS.items():
        np.testing.assert_array_equal(tdeck._LATTICE_BASIS[k], v, err_msg=k)


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.in")),
                         ids=lambda p: p.name)
def test_example_atoms_match_reference(path, tmp_path):
    """Each example deck's setup (up to its first run) creates the same
    atoms, bit for bit, in both runners."""
    setup, _ = deck_setup_and_rest(cut_deck(path.read_text(), tmp_path, 1,
                                            1))
    j, t = jdeck.DeckRunner(), DeckRunner()
    j.run_text(setup)
    t.run_text(setup)
    assert t.atoms["x"].shape[0] == j.atoms["x"].shape[0] > 0
    for k in j.atoms:
        np.testing.assert_array_equal(t.atoms[k], j.atoms[k], err_msg=k)


def test_two_body_deck_matches_reference(jax_exact, tmp_path):
    """two_body.in from a data file with the gap cut to 0.004: the
    collision starts inside the 30 steps."""
    data = (EXAMPLES / "two_body.data").read_text()
    data = data.replace("1 1 1.0 -0.6 0", "1 1 1.0 -0.502 0").replace(
        "2 1 1.0 0.6 0", "2 1 1.0 0.502 0")
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "close.data").write_text(data)
    text = cut_deck((EXAMPLES / "two_body.in").read_text(), tmp_path, 30,
                10, subs=(("examples/two_body.data",
                           str(tmp_path / "close.data")),))
    j, t = _run_both(text, tmp_path)
    assert t.thermo_log.rows[-1]["pe_pair"] > 0
    _compare(j, t)


def test_shear_cell_deck_matches_reference(jax_exact, tmp_path):
    """shear_cell.in in a 6-wide prism (64 particles, 3 grid cells an
    axis), its four stages cut to 6 steps: the tilt, the label/next/jump
    loop and the $() print."""
    text = cut_deck((EXAMPLES / "shear_cell.in").read_text(), tmp_path,
                6, 3, subs=(("variable        L equal 10",
                           "variable        L equal 6"),
                          ("fill block 0.4 9.6 0.4 9.6 0.4 9.6",
                           "fill block 0.4 5.6 0.4 5.6 0.4 5.6")))
    j, t = _run_both(text, tmp_path)
    assert t.atoms["x"].shape[0] == 64 and t.sim.triclinic
    np.testing.assert_allclose(np32(t.state.tilt), np.asarray(j.state.tilt),
                               rtol=1e-5)
    _compare(j, t)


def test_two_materials_deck_matches_reference(jax_exact, tmp_path):
    """two_materials.in (Lmax 8, two materials mixed geometrically, a wall
    with its own coefficients) with its fills cut to 3x3 columns (54
    particles, overlapping from the start), 8 steps, in the geometric law
    (``conservative off``): the reference's exact conservative law at
    Lmax 8 costs minutes to compile and seconds a step on the CPU; the
    port's conservative Lmax-8 law is held to it in test_torch_drum.py."""
    text = cut_deck((EXAMPLES / "two_materials.in").read_text(),
                tmp_path, 8, 4,
                subs=(("fill block 0.5 7.5 0.5 7.5 4 9",
                       "fill block 0.5 4.9 0.5 4.9 4 9"),
                      ("fill2 block 0.5 7.5 0.5 7.5 0.8 3.6",
                       "fill2 block 0.5 4.9 0.5 4.9 0.8 3.6"),
                      ("lmax 8\n", "lmax 8 conservative off\n")))
    j, t = _run_both(text, tmp_path)
    assert t.atoms["x"].shape[0] == 54 and t.sim.shapes.lmax == 8
    assert t.sim.params.pair_tab.shape == (2, 2, 8)
    assert t.thermo_log.rows[0]["pe_pair"] > 0
    _compare(j, t)


def test_settling_deck_matches_reference(jax_exact, tmp_path):
    """settling.in (64 ellipsoids, Lmax 2, five plane walls), 20 steps."""
    text = cut_deck((EXAMPLES / "settling.in").read_text(), tmp_path, 20,
                10)
    j, t = _run_both(text, tmp_path)
    assert t.atoms["x"].shape[0] == 64 and len(t.sim.walls) == 5
    _compare(j, t)


def test_jax_deck_restart_resumes_in_port(jax_exact, tmp_path):
    """A restart written by the JAX runner's ``write_restart`` resumes in
    the port's deck (``read_restart``) as in the reference's own."""
    common = """
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 8 0 8 0 8
create_box      1 box
shape           1 ellipsoid 0.5 0.45 0.4
lattice         sc 1.8
create_atoms    1 region box seed 3
velocity        all create 0.2 5
pair_style      spherharm 1e4 1e4 10 10 0.4 lmax 2 rolling 2e3 5 0.2 conservative off
pair_coeff      * *
timestep        1e-3
thermo          5
"""
    ckpt = tmp_path / "deck.restart"
    jdeck.DeckRunner().run_text(common + f"run 10\nwrite_restart {ckpt}\n")
    j = jdeck.DeckRunner().run_text(common + f"read_restart {ckpt}\nrun 10\n")
    t = DeckRunner().run_text(common + f"read_restart {ckpt}\nrun 10\n")
    assert int(t.state.step) == 20
    _compare(j, t)


def test_cuda_runner_without_card_raises(tmp_path):
    """No silent fall-back: the card asked for and none present raises,
    from the runner and from the CLI."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DeckRunner()
    out = subprocess.run(
        [sys.executable, "-m", "spherharm_tpu_torch.io.deck", "-q",
         str(EXAMPLES / "two_body.in")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_cli_runs_a_deck_on_the_cpu(tmp_path):
    """``python -m spherharm_tpu_torch.io.deck --device cpu`` runs a deck
    and prints its thermo table."""
    deck_path = tmp_path / "one.in"
    deck_path.write_text(f"""
units lj
boundary f f f
region box block -2 2 -2 2 -2 2
create_box 1 box
shape 1 sphere 0.4
pair_style spherharm 100000 28571 0 0 0
timestep 1e-3
create_atoms 1 single 0 0 0
velocity all set 1 0 0
fix 1 all nve/sh
thermo 5
dump 1 all custom 10 {tmp_path}/one.dump id x
run 10
""")
    out = subprocess.run(
        [sys.executable, "-m", "spherharm_tpu_torch.io.deck", "--device",
         "cpu", str(deck_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].split()[:3] == ["Step", "Atoms", "KinEng"]
    assert [int(ln.split()[0]) for ln in lines[1:]] == [0, 5, 10]
    frames = read_dump(tmp_path / "one.dump")
    assert [f["step"] for f in frames] == [0, 10]
    assert frames[1]["data"]["x"][0] == pytest.approx(0.01, abs=1e-6)


# -- tests/test_io.py's deck tests, mirrored -----------------------------


def test_deck_unknown_command():
    with pytest.raises(Exception, match="unsupported"):
        DeckRunner().run_text("bond_style harmonic\n")
    with pytest.raises(Exception, match="unsupported compute"):
        DeckRunner().run_text("compute 1 all cna/atom 3.0\n")


def test_deck_regions_and_lattices():
    """Sphere/cylinder/prism regions + fcc/bcc/hcp lattices fill with the
    right counts and all sites lie inside the region."""
    r = DeckRunner()
    r.run_text("""
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 10 0 10 0 10
create_box      1 box
shape           1 sphere 0.4
region          ball sphere 5 5 5 3
lattice         fcc 1.6
create_atoms    1 region ball
""")
    x = r.atoms["x"]
    assert x.shape[0] > 20
    assert np.all(np.sum((x - 5.0) ** 2, axis=1) <= (3.0 + 0.1) ** 2)

    r2 = DeckRunner()
    r2.run_text("""
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 10 0 10 0 10
create_box      1 box
shape           1 sphere 0.4
region          tube cylinder z 5 5 2.5 1 9
lattice         bcc 1.5
create_atoms    1 region tube
""")
    x2 = r2.atoms["x"]
    assert x2.shape[0] > 20
    d2 = (x2[:, 0] - 5) ** 2 + (x2[:, 1] - 5) ** 2
    assert np.all(d2 <= (2.5 + 0.1) ** 2)
    assert np.all((x2[:, 2] > 0.8) & (x2[:, 2] < 9.2))
    assert isinstance(r2.regions["tube"], CylinderRegion)
    assert isinstance(r2.regions["box"], BlockRegion)

    # hcp density ~ 4 sites per (a, sqrt3 a, sqrt(8/3) a) cell
    r3 = DeckRunner()
    r3.run_text("""
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 10 0 10 0 10
create_box      1 box
shape           1 sphere 0.4
lattice         hcp 1.5
create_atoms    1 region box
""")
    n_hcp = r3.atoms["x"].shape[0]
    vol_per_site = 1.5**3 * np.sqrt(3.0) * np.sqrt(8.0 / 3.0) / 4
    assert n_hcp == pytest.approx(1000 / vol_per_site, rel=0.25)

    pr = PrismRegion([0, 0, 0], [4, 4, 4], [2.0, 0.0, 0.0])
    assert pr.contains(np.array([[5.0, 3.9, 0.1]]))[0]   # sheared corner
    assert not pr.contains(np.array([[0.5, 3.9, 0.1]]))[0]
    assert SphereRegion([0, 0, 0], 1.0).contains(np.zeros((1, 3)))[0]


def test_deck_triclinic_prism_runs():
    """create_box from a prism region yields a tilted periodic cell and
    runs under the triclinic pipeline."""
    r = DeckRunner()
    r.run_text("""
units           lj
boundary        p p p
atom_style      spherharm
region          cell prism 0 8 0 8 0 8 1.5 0 0
create_box      1 cell
shape           1 sphere 0.45
lattice         sc 1.9
region          fill block 0.5 7.5 0.5 7.5 0.5 7.5
create_atoms    1 region fill seed 7
velocity        all create 0.05 11
pair_style      spherharm 1e4 1e4 5 5 0.3
pair_coeff      * *
timestep        1e-3
thermo          50
run             100
""")
    assert r.sim.triclinic
    assert float(r.state.tilt[0]) == 1.5
    assert len(r.thermo_log.rows) >= 2
    assert np.isfinite(r.thermo_log.series("ke")).all()


def test_deck_restart_roundtrip(tmp_path):
    """write_restart/read_restart deck commands resume bit-exact."""
    common = """
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 8 0 8 0 8
create_box      1 box
shape           1 ellipsoid 0.5 0.45 0.4
lattice         sc 1.8
create_atoms    1 region box seed 3
velocity        all create 0.2 5
pair_style      spherharm 1e4 1e4 10 10 0.4 lmax 2 rolling 2e3 5 0.2
pair_coeff      * *
timestep        1e-3
"""
    ckpt = tmp_path / "deck.restart"
    r1 = DeckRunner()
    r1.run_text(common + f"""
run             60
write_restart   {ckpt}
run             40
""")
    r2 = DeckRunner()
    r2.run_text(common + f"""
read_restart    {ckpt}
run             40
""")
    np.testing.assert_array_equal(np32(r1.state.x), np32(r2.state.x))
    np.testing.assert_array_equal(np32(r1.state.v), np32(r2.state.v))
    assert float(r1.sim.params.k_roll) == 2e3


def test_deck_variables_and_expressions(capsys):
    """variable equal/string + ${} / $() substitution + if/then/else."""
    r = DeckRunner()
    r.run_text("""
variable        two equal 1+1
variable        r equal sqrt(v_two^2)
variable        name string hello
print           "${name} $(v_r*3) ${two}"
if              "v_two == 2" then "print 'yes'" else "print 'no'"
if              "v_two > 5 || v_r > 1" then "print 'or-works'"
""")
    out = capsys.readouterr().out
    assert "hello 6.0 2" in out
    assert "yes" in out and "no" not in out
    assert "or-works" in out


def test_deck_loop_label_jump(capsys):
    """The canonical LAMMPS loop idiom: label / variable loop / next /
    jump SELF."""
    r = DeckRunner()
    r.run_text("""
label           top
variable        i loop 4
print           "iter $i"
next            i
jump            SELF top
print           "done"
""")
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("iter")] == [
        "iter 1", "iter 2", "iter 3", "iter 4"
    ]
    assert "done" in out
    assert "i" not in r.variables  # exhausted loop var deleted


def test_deck_variable_runs_simulation(capsys):
    """Variables parameterize real runs; thermo keywords (0-d tensors in
    the port) read as numbers in expressions after materialization."""
    r = DeckRunner()
    r.run_text("""
variable        n_steps equal 20*2
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 6 0 6 0 6
create_box      1 box
shape           1 sphere 0.45
lattice         sc 1.5
create_atoms    1 region box seed 3
velocity        all create 0.2 7
pair_style      spherharm 1e4 1e4 5 5 0.3
pair_coeff      * *
timestep        1e-3
run             ${n_steps}
if              "ke > 0" then "print 'ke=$(ke)'"
print           "vol=$(vol)"
print           "step=$(step) atoms=$(atoms)"
""")
    assert int(r.state.step) == 40
    out = capsys.readouterr().out
    assert "ke=" in out
    assert "vol=216" in out
    assert "step=40 atoms=64" in out


def test_deck_group_velocity():
    """group type + velocity <group> set: two single atoms of different
    types get opposing velocities and elastically swap them head-on
    (tests/test_io.py starts them 0.4 apart and runs 2,500 steps; here
    0.04 apart, 800 steps)."""
    deck_text = """
units lj
boundary f f f
region box block -2 2 -2 2 -2 2
create_box 2 box
shape 1 sphere 0.5
shape 2 sphere 0.5
pair_style spherharm 100000 28571 0 0 0 conservative off
timestep 2e-4
create_atoms 1 single -0.52 0 0
create_atoms 2 single 0.52 0 0
group left type 1
group right type 2
velocity left set 1.0 0 0
velocity right set -1.0 0 0
fix 1 all nve/sh
run 800
"""
    runner = DeckRunner().run_text(deck_text)
    v = by_tag(runner.state, "v")
    assert v[0, 0] == pytest.approx(-1.0, abs=5e-3)
    assert v[1, 0] == pytest.approx(1.0, abs=5e-3)


def test_deck_velocity_then_create_atoms():
    """velocity -> create_atoms -> velocity: atoms created after a
    velocity command start at rest until a later one selects them."""
    deck_text = """
units lj
boundary f f f
region box block -3 3 -3 3 -3 3
create_box 2 box
shape 1 sphere 0.4
shape 2 sphere 0.4
pair_style spherharm 100000 28571 0 0 0
timestep 2e-4
create_atoms 1 single -1.5 0 0
velocity all set 0.5 0 0
create_atoms 2 single 1.5 0 0
create_atoms 2 single 0 1.5 0
group newer type 2
velocity newer set -0.25 0 0
fix 1 all nve/sh
run 1
"""
    v = by_tag(DeckRunner().run_text(deck_text).state, "v")
    assert v[0, 0] == pytest.approx(0.5, abs=1e-6)
    assert v[1, 0] == pytest.approx(-0.25, abs=1e-6)
    assert v[2, 0] == pytest.approx(-0.25, abs=1e-6)


def test_deck_pair_style_conservative_flag():
    """`pair_style ... conservative {on|off}` parses and reaches the
    Simulation; the default is on."""
    assert DeckRunner().run_text(
        "pair_style spherharm 1e5 1e4 5 5 0.3").conservative is True
    assert DeckRunner().run_text(
        "pair_style spherharm 1e5 1e4 5 5 0.3 conservative off"
    ).conservative is False
    assert DeckRunner().run_text(
        "pair_style spherharm 1e5 1e4 5 5 0.3 conservative on"
    ).conservative is True
    with pytest.raises(Exception):
        DeckRunner().run_text(
            "pair_style spherharm 1e5 1e4 5 5 0.3 conservative maybe")


def test_deck_fix_freeze_boundary_particle():
    """fix <group> freeze: the frozen particle carries a landing
    particle's weight without moving; the mobile one comes to rest on top
    of it (tests/test_io.py drops it from 2.2 over 5,000 steps; here from
    1.52, 1,200 steps, the contact as overdamped)."""
    deck_text = """
units lj
boundary f f f
region box block -2 2 -2 2 -1 6
create_box 1 box
shape 1 sphere 0.5
pair_style spherharm 100000 28571 20000 250 0.3 conservative off
timestep 1e-4
create_atoms 1 single 0 0 0.5
create_atoms 1 single 0.05 0 1.52
region bottom block -2 2 -2 2 -1 1
group base region bottom
velocity base set 0 0 0
fix g all gravity 10 vector 0 0 -1
fix 1 all nve/sh
fix 2 base freeze
run 1200
"""
    runner = DeckRunner().run_text(deck_text)
    x, v = by_tag(runner.state, "x"), by_tag(runner.state, "v")
    np.testing.assert_allclose(x[0], [0.0, 0.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(v[0], 0.0, atol=1e-8)
    assert 1.2 < x[1, 2] < 1.6, x[1]
    assert abs(v[1, 2]) < 0.05
    assert runner.thermo_log.rows == []  # no thermo command, no rows


def test_deck_fix_setforce_null_components():
    """fix setforce NULL 0 0: the NULL component keeps gravity, the zeros
    override theirs."""
    deck_text = """
units lj
boundary f f f
region box block -5 5 -5 5 -5 5
create_box 1 box
shape 1 sphere 0.4
pair_style spherharm 100000 28571 0 0 0
timestep 1e-3
create_atoms 1 single 0 0 0
group one type 1
fix g all gravity 10 vector 1 0 0
fix 1 all nve/sh
fix 2 one setforce NULL 0 0
run 100
"""
    v = by_tag(DeckRunner().run_text(deck_text).state, "v")
    assert v[0, 0] == pytest.approx(10.0 * 100 * 1e-3, rel=1e-3)
    np.testing.assert_allclose(v[0, 1:], 0.0, atol=1e-7)


def test_deck_per_atom_compute_dump(tmp_path):
    """A per-atom compute as a dump column (``c_<id>``) and a scalar
    compute in the thermo rows: the port's tensors reach the file."""
    r = DeckRunner().run_text(f"""
units lj
boundary f f f
region box block -3 3 -3 3 -3 3
create_box 1 box
shape 1 sphere 0.4
pair_style spherharm 100000 28571 0 0 0
timestep 1e-3
create_atoms 1 single -1 0 0
create_atoms 1 single 1 0 0
velocity all set 0 0 2
compute k all ke/atom
compute t all temp
fix 1 all nve/sh
thermo 5
dump 1 all custom 5 {tmp_path}/ke.dump id c_k
run 5
""")
    frames = read_dump(tmp_path / "ke.dump")
    m = float(r.sim.shapes.vol[0])  # unit density
    np.testing.assert_allclose(frames[-1]["data"]["c_k"], [2 * m, 2 * m],
                               rtol=1e-6)
    assert r.thermo_log.rows[-1]["c_t"] == pytest.approx(4 * m / 3,
                                                         rel=1e-6)
    assert r.dump_formatters in (["native"] * 2, ["python"] * 2)


def test_deck_compute_command_matches_reference(jax_exact):
    """tests/test_computes.py's ``test_deck_compute_command`` in both
    runners: a scalar compute (``temp``) in the thermo rows and a per-atom
    one (``stress/atom``) through ``DeckRunner.compute``, 125 spheres over
    50 steps; the port's thermo column and stress rows held to the
    reference's (rtol 2e-3, the deck parity tolerance above; the stress
    at 2e-3 of its largest entry)."""
    text = """
units           lj
boundary        p p p
atom_style      spherharm
region          box block 0 6 0 6 0 6
create_box      1 box
shape           1 sphere 0.45
lattice         sc 1.2
create_atoms    1 region box seed 9
velocity        all create 0.3 4
pair_style      spherharm 1e4 1e4 5 5 0.3
pair_coeff      * *
compute         mytemp all temp
compute         sa all stress/atom
timestep        1e-3
thermo          25
run             50
"""
    j = jdeck.DeckRunner().run_text(text)
    t = DeckRunner().run_text(text)
    want = [row["c_mytemp"] for row in j.thermo_log.rows]
    got = [row["c_mytemp"] for row in t.thermo_log.rows]
    assert len(got) == len(want) == 3 and got[-1] > 0
    np.testing.assert_allclose(got, want, rtol=2e-3)
    n = int(t.state.n_active)
    assert n == int(j.state.n_active) == 125
    jsa, tsa = np.asarray(j.compute("sa"))[:n], np32(t.compute("sa"))[:n]
    assert tsa.shape == jsa.shape and tsa.shape[0] >= n
    np.testing.assert_allclose(tsa, jsa, rtol=0,
                               atol=2e-3 * np.abs(jsa).max())


def test_dump_peratom_compute_column_matches_reference(jax_exact, tmp_path):
    """tests/test_computes.py's ``test_dump_peratom_compute_column`` in both
    runners: ``coord/atom`` as the dump column ``c_1`` of two touching
    spheres reads [1, 1] in the port's file, as in the reference's, frame
    for frame."""
    frames = {}
    for sub, make in (("jax", jdeck.DeckRunner), ("port", DeckRunner)):
        out = tmp_path / sub / "c.dump"
        out.parent.mkdir()
        make().run_text(f"""
units lj
boundary f f f
region box block -2 2 -2 2 -2 2
create_box 1 box
shape 1 sphere 0.5
pair_style spherharm 100000 28571 0 0 0
timestep 2e-4
create_atoms 1 single -0.45 0 0
create_atoms 1 single 0.45 0 0
compute 1 all coord/atom
fix 1 all nve/sh
dump 1 all custom 10 {out} id x c_1
run 10
""")
        frames[sub] = read_dump(out)
    assert len(frames["port"]) == len(frames["jax"]) >= 1
    for tf, jf in zip(frames["port"], frames["jax"]):
        assert "c_1" in tf["columns"]
        assert list(np.asarray(tf["data"]["c_1"])) == [1.0, 1.0]
        np.testing.assert_array_equal(tf["data"]["c_1"], jf["data"]["c_1"])
        np.testing.assert_array_equal(tf["data"]["id"], jf["data"]["id"])


@pytest.mark.parametrize("name,dims",[("triaxial.in", (2, 2, 2)),
                                       ("two_materials.in", (3, 3, 3))])
def test_example_overflows_as_reference(name, dims, tmp_path):
    """Two example decks overflow in the reference's runner and the port's
    alike, with the same count at set-up: triaxial.in's periodic 6.4 box
    has 2 grid cells an axis, so the 27-stencil lists candidates once per
    stencil cell; two_materials.in's 150 overlapping blobs hold 830 pairs
    in the runner's pair capacity of max(4n, 512) = 600. (two_materials.in
    runs here in the geometric law: the count does not depend on it.)"""
    text = cut_deck((EXAMPLES / name).read_text(), tmp_path, 0, 1)
    text = text.replace("lmax 8\n", "lmax 8 conservative off\n")
    j, t = jdeck.DeckRunner().run_text(text), DeckRunner().run_text(text)
    assert t.sim.grid.dims == j.sim.grid.dims == dims
    assert int(t.neigh.overflow) == int(j.neigh.overflow) > 0
