"""The port's multi-device recon (tron_tpu_torch.parallel) vs the JAX
package's (tron_tpu.parallel) on the CPU.

One case for each of tests/test_sharding.py:24-303.  The JAX side runs here,
in the parent, on the virtual 8-device CPU mesh of tests/conftest.py; the
port's side runs in real ranks over gloo, started through
tron_tpu_torch.parallel.launch (worlds of 2 and 4, and one of 8 for the 4 x 2
mesh), each rank single-threaded.  Both meshes are built from one
description: ``ProcessMesh.from_jax(dict(jax_mesh.shape))``.  Inputs are
numpy arrays from seeds.  On the CPU the port's kernel wrappers take their
plain versions.

Every case is held against the JAX sharded result and the port's unsharded
one at rtol 2e-4, atol 2e-5, and the adjoint cases to 1e-5 NRMSE of the
port's unsharded recon; every rank must return the whole result, bit for bit
the same.  A world's cases run in one start of ranks (a module fixture), so
the file starts ranks a dozen times, not fifty.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import parallel as jpar
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.parallel import distributed as jdist
from tron_tpu_torch import recon
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.parallel import distributed, launch, make_mesh, make_spoke_mesh
from tron_tpu_torch.parallel.distributed import ProcessMesh

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
RANKS_TIMEOUT = 240.0  # s for one start of ranks; a hang fails there, not at the suite's limit


def _cplx(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


FRAMES, SPOKE, FORWARD, KOOSH = (
    "recon_frames_sharded", "recon_window_spoke_sharded", "recon_forward_sharded",
    "recon_stack_of_stars_sharded",
)
G = dict(golden_angle=True)
SW = dict(golden_angle=True, data_undersamp=0.5)  # sliding windows of nro/2 spokes

# name: (entry, mesh shape in mesh order, config, input shape, what follows cfg and mesh)
# frames: input (nc, npe1, nro), then skip0; spoke: (nc, npe, nro), then skip;
# forward: images (nc, nt, n, n, nz); koosh: (nc, nt, nro, npe1, npe2)
CASES = {
    # tests/test_sharding.py:24-58: frame, frame x coil (the 4 x 2 mesh), coil only
    "frame": (FRAMES, {"frame": 4, "coil": 1}, dict(SW, prof_slide=4), (2, 40, 32), (0,)),
    "frame_coil": (FRAMES, {"frame": 4, "coil": 2}, dict(SW, prof_slide=8), (4, 24, 32), (0,)),
    "coil_only": (FRAMES, {"frame": 1, "coil": 4}, G, (8, 16, 32), (0,)),
    "frame_w2": (FRAMES, {"frame": 2, "coil": 1}, dict(SW, prof_slide=4), (2, 40, 32), (5,)),
    "coil_w2": (FRAMES, {"frame": 1, "coil": 2}, dict(SW, prof_slide=4), (4, 40, 32), (0,)),
    # :61-93: the per-shard telescoping scan, with a block offset, sos and none
    "inc_sos_skip0": (FRAMES, {"frame": 2, "coil": 2},
                      dict(SW, prof_slide=4, incremental=True), (2, 44, 32), (0,)),
    "inc_sos_skip13": (FRAMES, {"frame": 2, "coil": 2},
                       dict(SW, prof_slide=4, incremental=True), (2, 44, 32), (13,)),
    "inc_none_skip13": (FRAMES, {"frame": 2, "coil": 2},
                        dict(SW, prof_slide=4, incremental=True, coil_combine="none"),
                        (2, 44, 32), (13,)),
    # :96-137: CGNR, Walsh, none
    "cgnr": (FRAMES, {"frame": 2, "coil": 2}, dict(G, niter=2), (2, 16, 32), (0,)),
    "cgnr_frames": (FRAMES, {"frame": 2, "coil": 2}, dict(SW, prof_slide=8, niter=2),
                    (4, 40, 32), (0,)),
    "walsh": (FRAMES, {"frame": 2, "coil": 2}, dict(SW, prof_slide=8, coil_combine="walsh"),
              (4, 24, 32), (0,)),
    "none": (FRAMES, {"frame": 2, "coil": 2}, dict(SW, prof_slide=8, coil_combine="none"),
             (4, 24, 32), (0,)),
    # :154-234: spoke adjoint, padding with a linear scheme, CGNR, Toeplitz
    "spoke": (SPOKE, {"spoke": 4}, G, (3, 48, 32), (0,)),
    "spoke_w2_skip": (SPOKE, {"spoke": 2}, G, (3, 48, 32), (9,)),
    "spoke_pad_linear": (SPOKE, {"spoke": 4}, dict(golden_angle=False), (2, 42, 32), (0,)),
    "spoke_cgnr": (SPOKE, {"spoke": 4}, dict(G, niter=3, coil_combine="none"), (2, 42, 32), (0,)),
    "spoke_toeplitz": (SPOKE, {"spoke": 4}, dict(G, niter=3, toeplitz=True, coil_combine="none"),
                       (1, 40, 32), (0,)),
    # :237-281: spoke x coil, with CGNR and with Walsh
    "spoke_coil": (SPOKE, {"spoke": 2, "coil": 2}, G, (4, 44, 32), (0,)),
    "spoke_coil_cgnr": (SPOKE, {"spoke": 2, "coil": 2}, dict(G, niter=2, coil_combine="none"),
                        (4, 40, 32), (0,)),
    "spoke_coil_walsh": (SPOKE, {"spoke": 2, "coil": 2}, dict(G, coil_combine="walsh"),
                         (4, 40, 32), (0,)),
    # :284-321: forward with a slice count that does not divide, forward -3
    "forward": (FORWARD, {"frame": 2, "coil": 2}, dict(SW, adjoint=False), (2, 1, 16, 16, 5), ()),
    "forward_koosh": (FORWARD, {"frame": 4, "coil": 1}, dict(SW, adjoint=False, koosh=True),
                      (2, 1, 16, 16, 6), ()),
    # the -3 adjoint, 3 slices over 2 frame coordinates (__graft_entry__.py:137-157)
    "koosh": (KOOSH, {"frame": 2, "coil": 1}, dict(SW, adjoint=True, koosh=True),
              (2, 1, 32, 16, 3), ()),
}
ADJOINT = {k for k, c in CASES.items() if c[0] in (FRAMES, SPOKE, KOOSH) and not c[2].get("niter")}


def _world(name) -> int:
    return int(np.prod(list(CASES[name][1].values())))


def _configs(name):
    kw = dict(CASES[name][2])
    kw.setdefault("adjoint", True)
    jcfg = JaxConfig(**kw)
    return jcfg, ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))


def _input(name):
    return _cplx(sorted(CASES).index(name), CASES[name][3])


def _geometry(name):
    cfg = _configs(name)[1]
    nc, npe1, nro = CASES[name][3]
    return cfg.frame_geometry(nro, npe1)


def _call(name) -> dict:
    entry, mesh, _, _, rest = CASES[name]
    args = [_input(name), *(_geometry(name) if entry == FRAMES else ()), *rest]
    return dict(entry=entry, mesh=mesh, cfg=_configs(name)[1], args=args)


def _run_world(world: int) -> dict:
    """All cases of one world size in one start of ranks; the first case
    runs a second time at the end (the repeat must be bitwise equal).
    -> {case: [rank 0's result, rank 1's, ...]}, and "results" for the ranks'
    records."""
    names = [k for k in CASES if _world(k) == world]
    calls = [_call(k) for k in names] + [_call(names[0])]
    results = launch.start_ranks(
        "tron_tpu_torch.parallel.launch:run_calls", world, {"calls": calls},
        device="cpu", timeout=RANKS_TIMEOUT,
    )
    out = {k: [r.value["results"][i] for r in results] for i, k in enumerate(names)}
    out["repeat"] = (names[0], [r.value["results"][len(names)] for r in results])
    out["results"] = results
    return out


@pytest.fixture(scope="module")
def world2():
    return _run_world(2)


@pytest.fixture(scope="module")
def world4():
    return _run_world(4)


@pytest.fixture(scope="module")
def world8():
    return _run_world(8)


def _jax_mesh(shape: dict):
    devs = jax.devices()[: int(np.prod(list(shape.values())))]
    if "spoke" in shape:
        return jpar.make_spoke_mesh(shape["spoke"], n_coil=shape.get("coil", 1), devices=devs)
    return jpar.make_mesh(n_frame=shape["frame"], n_coil=shape["coil"], devices=devs)


def _jax_sharded(name) -> np.ndarray:
    entry, shape, _, _, rest = CASES[name]
    jcfg, x, jmesh = _configs(name)[0], _input(name), _jax_mesh(CASES[name][1])
    assert dict(jmesh.shape) == shape  # the description the port's mesh is built from
    if entry == FRAMES:
        work, slide, nz = _geometry(name)
        return np.asarray(jpar.recon_frames_sharded(
            jnp.asarray(x), jcfg, jmesh, work, slide, nz, skip0=jnp.int32(rest[0])))
    if entry == SPOKE:
        return np.asarray(jpar.recon_window_spoke_sharded(jnp.asarray(x), jcfg, jmesh, skip=rest[0]))
    return np.asarray(getattr(jpar, entry)(x, jcfg, jmesh))


def _port_unsharded(name) -> np.ndarray:
    entry, _, _, _, rest = CASES[name]
    cfg, x = _configs(name)[1], _input(name)
    if entry == FRAMES:
        # the direct path: a shard telescopes from its own first frame, so
        # the unsharded incremental recon is no closer to it than this
        cfg = dataclasses.replace(cfg, incremental=False)
        return recon.recon_frames(torch.from_numpy(x), cfg, *_geometry(name), rest[0]).numpy()
    if entry == SPOKE:
        return recon.reconstruct_frame(torch.from_numpy(x), cfg.skip_angles + rest[0], cfg).numpy()
    return recon.recon_radial2d(x, cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_jax_and_unsharded(request, name):
    got_ranks = request.getfixturevalue(f"world{_world(name)}")[name]
    got = got_ranks[0]
    for r, other in enumerate(got_ranks[1:], 1):
        assert np.array_equal(other, got), f"rank {r} returned another result than rank 0"
    want_jax, want_port = _jax_sharded(name), _port_unsharded(name)
    assert got.shape == want_jax.shape == want_port.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want_port, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_jax, rtol=RTOL, atol=ATOL)
    if name in ADJOINT:
        assert nrmse(got, want_port) <= 1e-5
    else:
        assert nrmse(got, want_port) <= 1e-4 and nrmse(got, want_jax) <= 1e-4


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ranks_are_real_repeat_bitwise_and_import_no_jax(request, world):
    """Each world ran over gloo in its own processes, which imported neither
    JAX nor the JAX package and launched no kernel (CPU tensors take the
    plain versions); a sharded recon run twice in one world gives the same
    bits."""
    res = request.getfixturevalue(f"world{world}")
    assert len(res["results"]) == world
    for r in res["results"]:
        assert r.backend == "gloo" and r.device == "cpu" and r.imported == ()
        assert not any(r.launches.values())
    name, again = res["repeat"]
    for a, b in zip(res[name], again):
        assert np.array_equal(a, b)


def test_sharded_incremental_matches_sharded_direct(world4):
    """tests/test_sharding.py:61-93: the telescoping branch vs the direct
    sharded path of the same mesh (the port's unsharded direct recon is
    bitwise the frame-sharded one), at the incremental gate of 1e-4 per frame."""
    for name in ("inc_sos_skip0", "inc_sos_skip13", "inc_none_skip13"):
        inc, direct = world4[name][0], _port_unsharded(name)
        assert max(nrmse(inc[z], direct[z]) for z in range(direct.shape[0])) < 1e-4


def test_frame_sharding_alone_is_bitwise(world2, world4):
    """Frames are independent and a shard's frames are the same calls on the
    same numbers: sharding over 'frame' alone changes no bit."""
    for res, name in ((world4, "frame"), (world2, "frame_w2")):
        np.testing.assert_array_equal(res[name][0], _port_unsharded(name))


def test_distributed_single_process_mesh():
    """tests/test_sharding.py:140-148 on a world of one rank: no process
    group, every collective the identity, the frame slice all of nz."""
    assert not torch.distributed.is_initialized()
    mesh = distributed.make_global_mesh(n_coil=1, device="cpu")
    assert mesh.shape == {"frame": 1, "coil": 1} and mesh.size == 1
    assert all(a.group is None and a.index == 0 for a in mesh.axes)
    s, js = distributed.process_frame_slice(10), jdist.process_frame_slice(10)
    assert (s.start, s.stop) == (js.start, js.stop) == (0, 10)
    x = torch.arange(6.0).reshape(2, 3)
    assert distributed.psum(x, mesh.axis("coil")) is x
    assert distributed.all_gather_cat(x, mesh.axis("frame"), dim=1) is x
    assert make_spoke_mesh(device="cpu").shape == {"spoke": 1}
    assert make_spoke_mesh(device="cpu").axis("coil").size == 1  # an absent axis is trivial
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(n_frame=2, n_coil=1, device="cpu")
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4, adjoint=True)
    x = torch.from_numpy(_cplx(1, (2, 40, 32)))
    work, slide, nz = cfg.frame_geometry(32, 40)
    from tron_tpu_torch.parallel import recon_frames_sharded

    for c in (cfg, dataclasses.replace(cfg, incremental=True)):
        fn = recon.recon_frames_incremental if c.incremental else recon.recon_frames
        np.testing.assert_array_equal(
            recon_frames_sharded(x, c, make_mesh(device="cpu"), work, slide, nz, 3).numpy(),
            fn(x, c, work, slide, nz, 3).numpy())


def test_mesh_from_jax_description():
    jmesh = jpar.make_mesh(n_frame=1, n_coil=1, devices=jax.devices()[:1])
    mesh = ProcessMesh.from_jax(dict(jmesh.shape), device="cpu")
    assert mesh.axis_names == tuple(jmesh.axis_names) and mesh.shape == dict(jmesh.shape)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not cover"):
        ProcessMesh.from_jax({"frame": 4, "coil": 2}, device="cpu")


@pytest.mark.parametrize("n_coil,nz", [(1, 10), (2, 7), (1, 1)])
def test_process_frame_slice_and_global_mesh_two_processes(n_coil, nz):
    """Two ranks: the global mesh's shape and coordinates, and each rank's
    frame slice against the arithmetic of tron_tpu/parallel/distributed.py:
    60-74 with one frame-device per process (a process drives one device, so
    its index there is its frame coordinate)."""
    res = launch.start_ranks("tron_tpu_torch.parallel.launch:probe", 2,
                             {"nz": nz, "n_coil": n_coil}, device="cpu", timeout=RANKS_TIMEOUT)
    n_frame = 2 // n_coil
    per = -(-nz // n_frame)
    for rank, r in enumerate(res):
        i = rank // n_coil
        assert r.value["sum"] == 1.0  # ranks 0 + 1: the collective ran
        assert r.value["shape"] == {"frame": n_frame, "coil": n_coil}
        assert r.value["coords"] == {"frame": i, "coil": rank % n_coil}
        assert r.value["frames"] == (min(i * per, nz), min((i + 1) * per, nz))


def test_rank_that_raises_fails_the_start_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match=r"rank 1 of .*probe raised(.|\n)*asked to fail"):
        launch.start_ranks("tron_tpu_torch.parallel.launch:probe", 2, {"fail_rank": 1},
                           device="cpu", timeout=60.0)
    assert time.monotonic() - t0 < 60.0


def test_rank_that_hangs_is_stopped_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="did not finish within 6 s"):
        launch.start_ranks("tron_tpu_torch.parallel.launch:probe", 2, {"hang_rank": 0},
                           device="cpu", timeout=6.0)
    assert time.monotonic() - t0 < 30.0


def test_start_on_the_card_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.start_ranks("tron_tpu_torch.parallel.launch:probe", 2)
