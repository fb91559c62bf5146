"""The GEMM kernel's p16 table decode (csrc/posit_gemm.cu ``fill_p16_table``,
``p16_magnitude``, ``p16_f32``, ``p16_bf16x2``), emulated in plain torch by
``kernels/posit_gemm/ref.py`` (word layout, lane replication, second level
and pair packing included), against the reference's bit pipeline
``repro.core.codec.posit_decode``: every one of the 65,536 codes at es 0-3,
bit for bit as f32 and after ``.astype(jnp.bfloat16)``. NaR gives the plain
version's NaN as f32 (0x7FC00000) and a NaN as bf16 (the card's bf16 pack
gives its own NaN bits; XLA's cast may set the sign bit), checked apart.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.codec import posit_decode as jax_decode
from repro_torch.core.codec import posit_decode
from repro_torch.kernels.posit_gemm.ref import P16_RARE, p16_table_decode, p16_table_words

CODES = np.arange(1 << 16, dtype=np.uint16)
NAR = 0x8000


def _reference(es: int, bf16: bool) -> np.ndarray:
    x = jax_decode(jnp.asarray(CODES), 16, es)
    if bf16:
        return np.asarray(x.astype(jnp.bfloat16)).view(np.uint16)
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("es", [0, 1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_table_decode_matches_reference_on_every_code(es, bf16):
    got = p16_table_decode(torch.from_numpy(CODES.astype(np.int32)), es, bf16=bf16)
    got = got.view(torch.int16 if bf16 else torch.int32).numpy()
    got = got.view(np.uint16 if bf16 else np.uint32)
    want = _reference(es, bf16)
    live = CODES != NAR
    bad = np.flatnonzero(got[live] != want[live])
    assert bad.size == 0, [hex(int(c)) for c in CODES[live][bad[:8]]]
    # NaR: a NaN in the reference; the plain version's NaN as f32
    assert np.isnan(np.asarray(jax_decode(jnp.asarray(CODES[NAR:NAR + 1]), 16, es)))[0]
    if bf16:
        assert (int(got[NAR]) & 0x7F80) == 0x7F80 and (int(got[NAR]) & 0x7F) != 0
    else:
        assert int(got[NAR]) == 0x7FC00000


@pytest.mark.parametrize("es", [0, 3])
def test_table_decode_matches_port_codec_in_any_order(es):
    """Shuffled codes (every lane reads every row) and an odd count (a
    half-filled last pair) give the port codec's bits."""
    rng = np.random.default_rng(es)
    codes = torch.from_numpy(rng.permutation(CODES.astype(np.int32))[:40001])
    want = posit_decode(codes, 16, es)
    got = p16_table_decode(codes, es)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got16 = p16_table_decode(codes, es, bf16=True)
    live = (codes & 0xFFFF) != NAR
    assert torch.equal(got16[live].view(torch.int16),
                       want[live].to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_table_words_keep_their_fields_apart(es):
    """Each word holds T + sh: the shift 10..27 in bits 0-4, T with its low
    23 bits zero, the flag bit 5 clear; rows 0 and 255 hold only the flag;
    NaR's row gives 0xFFC00000 before the sign; the lanes' copies of a row
    are one word."""
    l1, l2 = p16_table_words(es)
    rows = l1.reshape(257, 32)
    assert (rows == rows[:, :1]).all()
    rows = rows[:, 0]
    assert int(rows[0]) == int(rows[255]) == P16_RARE
    assert int(rows[256]) == 0x7FC00000 + 16
    for words in (rows[1:255], l2):
        sh = words & 0x1F
        assert bool(((sh >= 10) & (sh <= 27)).all())
        assert bool(((words & P16_RARE) == 0).all())
        assert bool((((words - sh) & 0x7FFFFF) == 0).all())
