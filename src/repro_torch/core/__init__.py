"""repro_torch.core: the paper's contribution, unified posit/IEEE-754
transprecision, on torch tensors (the kernels on CUDA tensors, their plain
versions on CPU tensors).

Public API, the reference package's names where the port has them:
  formats:  PositFmt, FloatFmt, get_format, P8_0..P16_3, F32, BF16, F16
  codec:    posit_decode, posit_encode, quantize (bit-exact)
  pcsr:     OperandSlots (per-op), TransPolicy (per-run)
  fcvt:     Table-I conversion ops
  alu:      true-posit integer add/mul (PERCIVAL baseline) + fused quire ops
  dot:      posit_dot (fused / unfused / quire dataflows), posit_gemv,
            posit_matmul_wx, posit_softmax
  quire:    exact Kulisch accumulator (QuireFmt, quire_* ops, quire_matmul)
"""
from repro_torch.core.types import (  # noqa: F401
    BF16, ES_MAX, ES_MIN, F16, F32, Fmt, FloatFmt, P8_0, P8_1, P8_2, P8_3,
    P16_0, P16_1, P16_2, P16_3, PositFmt, compute_dtype_for, get_format,
)
from repro_torch.core.codec import posit_decode, posit_encode, quantize  # noqa: F401
from repro_torch.core.lut import (  # noqa: F401
    CODEC_IMPLS, decode_with_impl, encode_with_impl, lut_decode_p8, lut_decode_p16,
    lut_encode_p8, resolve_codec_impl,
)
from repro_torch.core.pcsr import (  # noqa: F401
    DATAFLOWS, FP32_POLICY, P8_SERVE, P16_TRAIN, P16_WEIGHTS, ROLES, OperandSlots,
    TransPolicy,
)
from repro_torch.core.convert import (  # noqa: F401
    fcvt_p8_p8, fcvt_p8_p16, fcvt_p8_s, fcvt_p16_p8, fcvt_p16_p16, fcvt_p16_s,
    fcvt_s_p8, fcvt_s_p16,
)
from repro_torch.core.alu import (  # noqa: F401
    posit_add, posit_mul, posit_sub, qclr, qma, qms, qneg, qround,
)
from repro_torch.core.dot import (  # noqa: F401
    ACTIVATIONS, FormatPlan, apply_epilogue, format_pair_plan, posit_dot,
    posit_gemv, posit_matmul_wx, posit_softmax,
)
from repro_torch.core.pack import (  # noqa: F401
    pack_p8, packed_decode_p8, packed_half_k, split_activations, unpack_p8,
)
from repro_torch.core.policy import (  # noqa: F401
    PRECISION_PRESETS, LayerRule, PrecisionPolicy, get_precision_policy,
)
from repro_torch.core.quire import (  # noqa: F401
    QuireFmt, quire_accumulate, quire_add_posit, quire_dot, quire_from_posit,
    quire_is_nar, quire_matmul, quire_negate, quire_normalize, quire_read,
    quire_read_f32, quire_zero,
)
