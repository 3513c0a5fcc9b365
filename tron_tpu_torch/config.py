"""Reconstruction configuration (counterpart of `tron_tpu/config.py`).

One frozen dataclass carries every knob of the reference CLI
(`src/tron.cu:794-874`) that the port runs, plus the Hopper kernel tuning
(`KernelTuning`).  The TPU-only parts of the JAX config (`dft_dot`, the
MXU DFT dot algorithm, and the VMEM / Mosaic / scan-blocking / tiling knobs
of its `KernelTuning`) have no counterpart here; `ReconConfig.from_jax_fields`
drops them when a JAX config is carried over.
"""

from __future__ import annotations

import dataclasses
import math
import os


class AngleScheme:
    """Spoke-angle conventions.

    The reference uses *different* linear-angle conventions in its grid and
    degrid kernels (grid: pe*2*pi/npe + pi/2 at `src/tron.cu:509`; degrid:
    pe*pi/npe at `src/tron.cu:555`).  Here the scheme is explicit and the
    same scheme is used for both directions.
    """

    GOLDEN = "golden"           # modang(PHI * (pe + skip)); PHI = pi/golden-ratio
    LINEAR_HALF = "linear_half"  # pe * pi / npe           (reference degrid convention)
    LINEAR_FULL = "linear_full"  # pe * 2*pi / npe + pi/2  (reference grid convention)


# Golden angle increment in radians = pi / ((1+sqrt(5))/2) ~= 111.246 deg
# (`src/tron.cu:90`).
PHI = math.pi / ((1.0 + math.sqrt(5.0)) / 2.0)

# Fields of the JAX config that only steer TPU code generation.
_TPU_ONLY_FIELDS = ("dft_dot",)


@dataclasses.dataclass(frozen=True)
class KernelTuning:
    """Hopper kernel tuning (counterpart of `tron_tpu.config.KernelTuning`,
    which also carries the TPU's VMEM, Mosaic, scan-blocking and tiling
    knobs; those have no role on the card).  ``ReconConfig.tuning`` left at
    None resolves through ``from_env`` at each call, so a clean environment
    gives these defaults."""

    # batched-eval gridding: the tile gridding kernel with its contraction a
    # static unroll on tensor cores (B5 `_win_kernel_batched`: bf16 MMAs at
    # the bf16 classes, 3xTF32 at float32), the same class as the default
    # tile kernel
    batched: bool = False

    @classmethod
    def from_env(cls) -> "KernelTuning":
        """Defaults with the TRON_* environment overrides
        (`tron_tpu/config.py:115-145`): ``TRON_BATCHED=1`` sets batched."""
        return cls(batched=int(os.environ.get("TRON_BATCHED", "0")) != 0)


def _carry_tuning(t: dict | None) -> KernelTuning | None:
    """A JAX ``KernelTuning`` (as a dict from ``dataclasses.asdict``) ->
    the port's: ``batched`` is kept, the TPU-only knobs are dropped."""
    return None if t is None else KernelTuning(batched=bool(t["batched"]))


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    # Geometry / kernel (reference defaults at src/tron.cu:66-69)
    gridos: float = 2.0          # -o grid oversampling factor
    kernwidth: float = 2.0       # -k kernel half-width in oversampled grid units
    beatty: bool = False         # -DBEATTY_BETA variant of the KB shape

    # Trajectory
    golden_angle: bool = False   # -G
    skip_angles: int = 0         # -s
    angle_scheme: str | None = None  # override; default derived per direction

    # Sliding-window framing (src/tron.cu:904-935)
    data_undersamp: float = 1.0  # -u
    prof_slide: int = 0          # -d (0 -> npe1work, i.e. non-overlapping frames)

    # Pipeline
    adjoint: bool = False        # -a
    deapodize: bool = True       # on by default (src/tron.cu:87)
    sdc: str = "ramlak"          # "ramlak" (reference parity) | "ideal"
    niter: int = 0               # -i CGNR iterations (0 = plain adjoint)
    toeplitz: bool = False       # --toeplitz (CGNR normal operator as FFT conv)
    koosh: bool = False          # -3 (3D stack handling)
    incremental: bool = False    # telescoping sliding-window gridding: frame
                                 # z+1's k-space grid = frame z's grid
                                 # - (leaving spokes) + (entering spokes);
                                 # golden-angle overlapping windows only
    coil_combine: str = "sos"    # "sos" | "walsh" | "none"
    walsh_npatch: int = 1
    coil_compress: int = 0       # SVD-compress to N virtual coils (0 = off)

    # Implementation knobs
    backend: str = "auto"        # "jnp": plain torch gridder on any device;
                                 # "pallas": the CUDA kernel (raises on a CPU
                                 # tensor); "auto": the kernel for a CUDA
                                 # tensor, the plain version for a CPU tensor
    matmul_dtype: str = "bfloat16"   # precision class of the kernels
                                     # ("bfloat16" | "bf16x2" | "bf16x3" |
                                     # "float32", ops/precision.py): on the
                                     # card each kernel computes it as its
                                     # Pallas twin does; a CPU tensor's main
                                     # path runs float32, as JAX's jnp path
                                     # (nufft.kernel_class)
    pe_chunk: int = 8            # spokes per step of the plain dense gridder
    tuning: KernelTuning | None = None  # None: defaults with TRON_* env
                                        # overrides (KernelTuning.from_env)

    @classmethod
    def from_jax_fields(cls, d: dict) -> "ReconConfig":
        """Build the port's config from ``dataclasses.asdict()`` of a
        ``tron_tpu.config.ReconConfig``.  TRON has no learned weights: its
        state is this configuration plus the KB constants derived from it
        (``kb_beta``), so this is the one place state crosses packages.  The
        TPU-only keys are dropped, ``tuning`` keeps only ``batched``; any
        other unknown key raises."""
        kw = {k: v for k, v in d.items() if k not in _TPU_ONLY_FIELDS}
        kw["tuning"] = _carry_tuning(kw.get("tuning"))
        return cls(**kw)

    def kernel_tuning(self) -> KernelTuning:
        """The tuning the kernels run with (`tron_tpu/config.py:222-227`)."""
        return self.tuning if self.tuning is not None else KernelTuning.from_env()

    def scheme_for(self, direction: str) -> str:
        """Angle scheme for 'forward' or 'adjoint', honoring the override."""
        if self.golden_angle:
            return AngleScheme.GOLDEN
        if self.angle_scheme is not None:
            return self.angle_scheme
        return (
            AngleScheme.LINEAR_FULL if direction == "adjoint" else AngleScheme.LINEAR_HALF
        )

    def npe1work(self, nro: int, npe1: int) -> int:
        """Profiles per frame (`src/tron.cu:916-919`)."""
        cap = int(nro * self.data_undersamp)
        return npe1 if npe1 <= cap else cap

    def frame_geometry(self, nro: int, npe1: int) -> tuple[int, int, int]:
        """(npe1work, prof_slide, nz) for a sliding-window recon
        (`src/tron.cu:916-928`)."""
        work = self.npe1work(nro, npe1)
        slide = self.prof_slide if self.prof_slide > 0 else work
        nz = 1 + (npe1 - work) // slide
        return work, slide, nz
