"""Hardware specification for the SimDIT accelerator model (paper Table II).

Two engines (paper Sec. III):
  * a J x K systolic PE array for Conv/FC (``weight-stationary``), fed by
    four double-buffered SRAMs (WBuf, BBuf, IBuf, OBuf), and
  * a 1 x K SIMD ALU array for every non-Conv op, fed by a single-buffered
    vector memory (VMem) plus an instruction memory (IMem).

Units convention used throughout ``repro_torch.core``:
  * buffer sizes     : bytes
  * bit widths       : bits
  * DRAM bandwidths  : bits / cycle (per off-chip interface, as in the paper)
  * access counts    : bits (the paper's ``A_* = V * M * b`` form); element
                       counts are reported separately where useful.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict

KB = 1024


@dataclass(frozen=True)
class HardwareSpec:
    """Parameterizable accelerator substrate (paper Table II)."""

    name: str = "custom"
    # Systolic array
    J: int = 64                      # PE rows   (ic mapped along rows)
    K: int = 64                      # PE cols   (oc mapped along cols; also #ALUs)
    wbuf: int = 1024 * KB            # weight buffer, bytes
    bbuf: int = 32 * KB              # bias buffer, bytes
    ibuf: int = 512 * KB             # ifmap buffer, bytes
    obuf: int = 1024 * KB            # ofmap/psum buffer, bytes
    # SIMD array
    vmem: int = 1024 * KB            # vector memory, bytes
    imem: int = 64 * KB              # instruction memory, bytes
    # Bit widths (systolic)
    b_w: int = 16                    # weight
    b_b: int = 32                    # bias
    b_i: int = 16                    # ifmap
    b_p: int = 32                    # psum / ofmap
    # Bit widths (SIMD)
    b_in: int = 32
    b_out: int = 32
    # Per-interface DRAM bandwidth, bits/cycle
    bw_w: int = 512                  # shared WBuf + BBuf interface
    bw_i: int = 512                  # IBuf interface
    bw_o: int = 512                  # OBuf interface
    bw_v: int = 512                  # VMem interface
    # ALU issue cycles per arithmetic op type. The SIMD array is pipelined
    # (Sec. IV-E: "pipeline stages ... similar to a general MIPS processor"),
    # so simple ops sustain 1/cycle; iterative ops (div, sqrt) cost more.
    # hash=False keeps the frozen spec hashable (dicts aren't); two specs
    # differing only in ``lat`` hash-collide but still compare unequal.
    lat: Dict[str, int] = field(hash=False, default_factory=lambda: dict(
        add=1, sub=1, mul=1, div=2, max=1, cmp=1, exp=2, sqrt=2, rsqrt=2, copy=1))

    # ---- derived helpers -------------------------------------------------
    @property
    def pso_sa(self) -> int:
        """Systolic pipeline setup overhead per outer tile: (J-1)+(K-1)."""
        return (self.J - 1) + (self.K - 1)

    @property
    def pso_simd(self) -> int:
        """SIMD pipeline setup overhead: 6-stage MIPS pipe + K-ALU skew."""
        return (6 - 1) + (self.K - 1)

    def lam(self, op: str) -> int:
        return self.lat[op]

    def replace(self, **kw) -> "HardwareSpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Paper presets (Sec. VII-A).
#
# Training hardware HT1-3: 16-bit ifmap/weight, 32-bit psum, 32-bit SIMD.
# Inference hardware HI1-3:  8-bit ifmap/weight, 32-bit psum, 32-bit SIMD.
# "Bandwidth per off-chip interface = X bits/cycle" applies to each of the
# four interfaces.
# ---------------------------------------------------------------------------

def _train_bits() -> dict:
    return dict(b_w=16, b_i=16, b_p=32, b_b=32, b_in=32, b_out=32)


def _infer_bits() -> dict:
    return dict(b_w=8, b_i=8, b_p=32, b_b=32, b_in=32, b_out=32)


HT1 = HardwareSpec(name="HT1", J=16, K=16,
                   wbuf=256 * KB, ibuf=128 * KB, obuf=256 * KB, vmem=256 * KB,
                   bbuf=16 * KB, bw_w=128, bw_i=128, bw_o=128, bw_v=128,
                   **_train_bits())
HT2 = HardwareSpec(name="HT2", J=32, K=32,
                   wbuf=512 * KB, ibuf=256 * KB, obuf=512 * KB, vmem=512 * KB,
                   bbuf=32 * KB, bw_w=256, bw_i=256, bw_o=256, bw_v=256,
                   **_train_bits())
HT3 = HardwareSpec(name="HT3", J=64, K=64,
                   wbuf=1024 * KB, ibuf=512 * KB, obuf=1024 * KB, vmem=1024 * KB,
                   bbuf=64 * KB, bw_w=512, bw_i=512, bw_o=512, bw_v=512,
                   **_train_bits())

HI1 = HardwareSpec(name="HI1", J=16, K=16,
                   wbuf=32 * KB, ibuf=32 * KB, obuf=128 * KB, vmem=128 * KB,
                   bbuf=16 * KB, bw_w=128, bw_i=128, bw_o=128, bw_v=128,
                   **_infer_bits())
HI2 = HardwareSpec(name="HI2", J=32, K=32,
                   wbuf=256 * KB, ibuf=128 * KB, obuf=512 * KB, vmem=512 * KB,
                   bbuf=32 * KB, bw_w=256, bw_i=256, bw_o=256, bw_v=256,
                   **_infer_bits())
HI3 = HardwareSpec(name="HI3", J=64, K=64,
                   wbuf=512 * KB, ibuf=256 * KB, obuf=1024 * KB, vmem=1024 * KB,
                   bbuf=64 * KB, bw_w=512, bw_i=512, bw_o=512, bw_v=512,
                   **_infer_bits())

TRAIN_PRESETS = {16: HT1, 32: HT2, 64: HT3}
INFER_PRESETS = {16: HI1, 32: HI2, 64: HI3}
