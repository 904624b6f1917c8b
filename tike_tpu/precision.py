"""Global dtype and matmul-precision policy for tike-tpu.

Mirrors the reference policy (`upstream/src/tike/precision.py:1-12`):
all compute is float32 / complex64. Ptychographic phase retrieval is FFT- and
phase-dominated, so single precision is the accuracy floor.
"""

import numpy as np
import jax
import jax.numpy as jnp

floating = np.float32
cfloating = np.complex64
integer = np.int32

jfloating = jnp.float32
jcfloating = jnp.complex64
jinteger = jnp.int32

# Matrix products inside the solvers' patch operators (the bilinear
# selection einsums of ops/patch.py); the parity surface (simulate, the
# operator API) keeps its own HIGHEST default. On an H100 (700 W) at the
# headline widths, DEFAULT and HIGH run in TF32 and miss HIGHEST by up to
# 1.7e-3 (relative, per output); three bf16 passes (bf16x3) miss it by at
# most 9e-6 and make the headline LSQML epoch 1.39x faster than HIGHEST
# (1.40x on a card held to 400 W). profile/precision_sweep.py measures it.
SOLVER_MATMUL = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
