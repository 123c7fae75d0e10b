"""The yardstick of the rooflines and of the whole step's share of the
chip: published peaks of one NVIDIA H100 SXM5 80 GB, and the least time a
piece of work could take on it.

Work is counted from shapes and settings only, never from the program's
counters, as the least that any correct implementation must do (so that no
later design can read above 100%):

- ``products``: flops of products that a tensor core may do (a GEMM, or a
  dot per Gram entry), a multiply-add counted as 2;
- ``ops``: instructions on the FP32 pipe (an add, a multiply or a fused
  multiply-add each 1);
- ``exps``: exponentials;
- ``bytes``: each input byte read once and each output byte written once.

Rates, for the float32 the configurations state (NVIDIA's H100 SXM5 data
sheet, dense, no sparsity): float32-accurate
products at a third of the dense TF32 tensor-core rate (three TF32 passes,
hi*hi + hi*lo + lo*hi, keep float32's accuracy; the fastest such route,
faster than the 67 TFLOP/s of FP32 FMA); the FP32 pipe at 67 TFLOP/s, 33.5
T instructions/s; HBM3 at 3.35 TB/s. An exp is charged at the fastest rate
the chip reaches by any route: the special-function units (16 a clock per
SM at the 1980 MHz boost clock) and a polynomial on the FP32 pipe
(``FMA_OPS_PER_EXP`` instructions: the scale by log2 e, the split into
integer and fraction by a magic-number add and a subtract, a degree-5
Horner polynomial for 2^f on [-1/2, 1/2], about 2e-7 relative error) at
once. Both routes share the FP32 pipe's time with the other
instructions, so the FP32 time is

    max(ops / OPS, (ops + FMA_OPS_PER_EXP * exps) / (OPS + FMA_OPS_PER_EXP * SFU)),

the first term where the special-function units alone take all the exps.
The least time is the largest of that, the products' and the bytes'.
"""

from dataclasses import dataclass

__all__ = ["Work", "least_time", "PEAKS", "FMA_OPS_PER_EXP"]

SM_COUNT = 132
BOOST_CLOCK_HZ = 1.98e9
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "tf32_tc_flops": 495e12,
    "sfu_exps_per_s": 16 * SM_COUNT * BOOST_CLOCK_HZ,
}
#: Float32-accurate products: three TF32 tensor-core passes.
PRODUCT_FLOPS = PEAKS["tf32_tc_flops"] / 3
#: FP32 pipe instructions a second (an FMA is one instruction, two flops).
OPS = PEAKS["fp32_flops"] / 2
FMA_OPS_PER_EXP = 8


@dataclass(frozen=True)
class Work:
    products: float = 0.0
    ops: float = 0.0
    exps: float = 0.0
    bytes: float = 0.0

    def __add__(self, other):
        return Work(self.products + other.products, self.ops + other.ops,
                    self.exps + other.exps, self.bytes + other.bytes)

    def __mul__(self, k):
        return Work(self.products * k, self.ops * k, self.exps * k, self.bytes * k)

    __rmul__ = __mul__


def times(work):
    """Seconds each resource needs for ``work``."""
    sfu = PEAKS["sfu_exps_per_s"]
    fp32 = max(work.ops / OPS,
               (work.ops + FMA_OPS_PER_EXP * work.exps) / (OPS + FMA_OPS_PER_EXP * sfu))
    return {"products": work.products / PRODUCT_FLOPS, "fp32_pipe_and_exps": fp32,
            "bytes": work.bytes / PEAKS["hbm_bytes_per_s"]}


def least_time(work):
    """The least seconds ``work`` could take on one H100."""
    return max(times(work).values())


def share(work, seconds):
    """``work``'s least time over ``seconds`` measured, in percent."""
    return 100.0 * least_time(work) / seconds
