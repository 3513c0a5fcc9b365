"""The direct scheduler's angle table and frame loop on the CPU
(`recon.recon_frames`, hoisted planes path).

Every frame's spoke angles come from one table built in the sample prep
(`trajectory.spoke_angle_table`), each row bitwise the per-frame
`spoke_angles` call it replaces.  On the CPU the loop stays eager: no CUDA
graph is captured or replayed, and the images are bitwise those of the
per-frame chain.  The graph itself runs only on the card
(`tests/test_torch_cuda.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon
from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint_planes, sdc_weights
from tron_tpu_torch.ops import grid_cuda
from tron_tpu_torch.trajectory import spoke_angle_table, spoke_angles

torch.set_num_threads(1)

# the whole-body series: 204 spokes a frame sliding by 21, 956 frames, from skip_angles 0
SKIP_ANGLES, WORK, SLIDE, NZ = 0, 204, 21, 956
SCHEMES = (AngleScheme.GOLDEN, AngleScheme.LINEAR_FULL, AngleScheme.LINEAR_HALF)


@pytest.mark.parametrize("skip0", [1234, 2**24 + 3])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_angle_table_rows_are_spoke_angles(scheme, skip0):
    """Past 2**24 the skip rounds on its way to float32: the table rounds
    it as the per-frame call does."""
    skips = SKIP_ANGLES + skip0 + SLIDE * torch.arange(NZ)
    table = spoke_angle_table(WORK, scheme, skips)
    assert table.shape == (NZ, WORK) and table.dtype == torch.float32
    for z in range(NZ):
        want = spoke_angles(WORK, scheme, SKIP_ANGLES + skip0 + z * SLIDE)
        assert torch.equal(table[z], want), z


def _per_frame(data, cfg, work, slide, nz, skip0):
    """The hoisted path as a loop of per-frame `spoke_angles` calls."""
    nro = data.shape[-1]
    nxos = int((nro // 2) * cfg.gridos)
    w = sdc_weights(cfg, nro, work, data.device).to(data.dtype)
    planes = grid_cuda.to_sample_planes(data * w, nxos)
    scheme = cfg.scheme_for("adjoint")
    return torch.stack([
        recon._combine(nufft_adjoint_planes(
            planes[z * slide : z * slide + work],
            spoke_angles(work, scheme, cfg.skip_angles + skip0 + z * slide), cfg), cfg)
        for z in range(nz)
    ])


@pytest.mark.parametrize("combine", ["sos", "walsh", "none"])
@pytest.mark.parametrize("golden", [True, False])
def test_cpu_frame_loop_is_eager_and_unchanged(combine, golden):
    """3 coils, 64 readouts, 25 spokes a frame sliding by 21, 4 frames,
    from profile 7 of a series with skip_angles 5."""
    cfg = ReconConfig(adjoint=True, golden_angle=golden, data_undersamp=0.4, prof_slide=21,
                      skip_angles=5, coil_combine=combine)
    work, slide, nz = cfg.frame_geometry(64, 25 + 3 * 21)
    assert (work, slide, nz) == (25, 21, 4)
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 3, 25 + 3 * 21, 64), np.float32)
    data = torch.from_numpy((x[0] + 1j * x[1]).astype(np.complex64))
    recon.reset_frame_graph_counts()
    got = recon.recon_frames(data, cfg, work, slide, nz, skip0=7)
    assert recon.FRAME_GRAPH_COUNTS == {"captured": 0, "replayed": 0, "eager": nz}
    assert torch.equal(got, _per_frame(data, cfg, work, slide, nz, 7))


@pytest.mark.parametrize("change", [{"incremental": True}, {"niter": 2}, {"adjoint": False}])
def test_other_schedulers_capture_no_graph(change):
    """The incremental scheduler, CGNR and the forward operator bypass the
    graph, and only the direct scheduler counts its frames."""
    cfg = dataclasses.replace(
        ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.5, prof_slide=16), **change)
    rng = np.random.default_rng(23)
    shape = (2, 1, 64, 64) if cfg.adjoint else (2, 1, 32, 32, 2)
    indata = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    recon.reset_frame_graph_counts()
    recon.recon_radial2d(indata, cfg, device="cpu")
    want = {"captured": 0, "replayed": 0, "eager": 3 if "niter" in change else 0}
    assert recon.FRAME_GRAPH_COUNTS == want
