"""The port's Zstandard decoder and CRC-32C (`upgpt_torch/native/
zstd_core.cpp` through `upgpt_torch.native.zstd`) against the `zstandard`
module, on the CPU.

Frames from `zstandard` at levels 1, 3, 9, 19 and 22 (the last two on
the first 256 KB), with and without the content size and the XXH64
checksum, over empty, 1 B, 4 KB, 1 MB and 8 MB inputs of float32 weights,
zeros, text and random bytes decode to their input; so do frames back to
back, skippable frames between them, a streamed frame of many blocks and
a hypothesis round trip, and inputs that reach the rarer header forms
(4-bit Huffman weights, 3-byte raw literal headers, blocks of more than
0x7F00 sequences). Frames that name a dictionary are refused. Truncated and
byte-flipped frames raise ValueError or decode to other bytes, never
crash (each case runs in this process). CRC-32C against known vectors;
a build failure raises with the compiler's message.
"""

import struct

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from upgpt_torch.native import zstd  # noqa: E402

RNG = np.random.default_rng(0)
INPUTS = {
    "empty": b"",
    "one_byte": b"\x7f",
    "weights_4k": (0.05 * RNG.standard_normal(1024)).astype(
        np.float32).tobytes(),
    "weights_1m": (0.05 * RNG.standard_normal(1 << 18)).astype(
        np.float32).tobytes(),
    "zeros_1m": bytes(1 << 20),
    "random_4k": RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
    "random_1m": RNG.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
    "text_8m": b"".join(b"layer %d: weight %d of the U-Net\n" % (i % 97, i)
                        for i in range(260_000))[:8 << 20],
    "weights_8m": np.resize((0.05 * RNG.standard_normal(5000)).astype(
        np.float32), 2 << 20).tobytes(),
}
LEVELS = (1, 3, 9, 19, 22)


def _frame(data: bytes, level: int, size: bool, checksum: bool) -> bytes:
    return zstandard.ZstdCompressor(
        level=level, write_content_size=size,
        write_checksum=checksum).compress(data)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
def test_levels_and_inputs(name, level):
    data = INPUTS[name]
    if level >= 19:
        data = data[:1 << 18]  # the slow levels on 256 KB
    for size in (True, False):
        for checksum in (True, False):
            frame = _frame(data, level, size, checksum)
            assert bytes(zstd.decompress(frame)) == data
            assert bytes(zstd.decompress(frame, size=len(data))) == data


def _rare_inputs():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (1024, 3), dtype=np.uint8)
    noise = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    return {
        # 3-byte tokens: blocks of more than 0x7F00 sequences
        "tokens": (tokens[rng.integers(0, 1024, (1 << 19) // 3)].tobytes(),
                   (19, 22)),
        # incompressible literals between matches: raw literal sections
        # of more than 4095 bytes (a 3-byte header)
        "noise": (b"".join(noise[i * 100:(i + 1) * 100] + noise[:50]
                           for i in range(60)) * 2, (1, 3)),
        # small alphabets: Huffman weights written as 4-bit values
        **{f"alphabet_{a}": (rng.integers(0, a, 5000, dtype=np.uint8)
                             .tobytes(), (1, 19)) for a in (4, 16, 100)},
    }


@pytest.mark.parametrize("name", sorted(_rare_inputs()))
def test_rare_header_forms(name):
    data, levels = _rare_inputs()[name]
    for level in levels:
        assert bytes(zstd.decompress(_frame(data, level, False, True))) == data


def test_frame_header_fields():
    data = INPUTS["weights_4k"]
    with_size = _frame(data, 3, True, True)
    without = _frame(data, 3, False, False)
    assert zstd.content_size(with_size) == len(data)
    assert zstd.content_size(without) is None
    assert without[4] & 0xC0 == 0  # no content size, as tensorstore writes
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress(without, size=len(data) + 1)
    with pytest.raises(ValueError, match="cap"):
        zstd.decompress(without, cap=1000)


def test_concatenated_and_skippable_frames():
    parts = [INPUTS["random_4k"], INPUTS["weights_4k"], b"", b"tail"]
    skip = struct.pack("<II", 0x184D2A57, 5) + b"\x00" * 5
    stream = skip + b"".join(_frame(p, 1 + i, i % 2 == 0, i % 2 == 1) + skip
                             for i, p in enumerate(parts))
    assert bytes(zstd.decompress(stream)) == b"".join(parts)
    assert zstd.content_size(stream) is None
    sized = b"".join(_frame(p, 3, True, False) for p in parts)
    assert zstd.content_size(sized) == sum(map(len, parts))
    assert bytes(zstd.decompress(sized)) == b"".join(parts)


def test_streamed_frame_of_many_blocks():
    data = INPUTS["weights_1m"] + INPUTS["text_8m"][:1 << 20]
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    obj = cctx.compressobj()
    frame = b"".join([obj.compress(data[i:i + 70_000])
                      for i in range(0, len(data), 70_000)]
                     + [obj.flush()])
    assert bytes(zstd.decompress(frame)) == data
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


def test_dictionary_frames_are_refused():
    samples = [b"key %d value %d pad" % (i, i * 7) for i in range(2000)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[5] * 4)
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


def _corruptions(frame: bytes, rng):
    for cut in sorted({1, 3, 4, 6, len(frame) // 2, len(frame) - 1}):
        yield frame[:cut]
    for _ in range(60):
        b = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
        yield bytes(b)


@pytest.mark.parametrize("name", ["weights_4k", "text_8m", "random_4k",
                                  "weights_8m"])
def test_truncated_and_flipped_frames_never_crash(name):
    """Every corrupted frame raises ValueError or decodes; a truncated one
    never decodes to the input, and with a checksum whatever decodes is
    the input (a corruption the checksum misses has odds of 2**-32)."""
    data = INPUTS[name][:200_000]
    rng = np.random.default_rng(5)
    for level in (1, 19):
        for checksum in (True, False):
            frame = _frame(data, level, checksum, checksum)
            for bad in _corruptions(frame, rng):
                try:
                    out = bytes(zstd.decompress(bad, cap=4 * len(data)))
                except ValueError:
                    continue
                if len(bad) < len(frame):
                    assert out != data
                elif checksum:
                    assert out == data


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=3000), st.integers(1, 19), st.booleans())
def test_round_trip_random_bytes(data, level, checksum):
    frame = _frame(data * 3, level, checksum, checksum)
    assert bytes(zstd.decompress(frame)) == data * 3


@settings(max_examples=200, deadline=None)
@given(st.binary(min_size=1, max_size=64), st.data())
def test_random_junk_never_crashes(prefix, draw):
    frame = _frame(INPUTS["weights_4k"], 3, False, False)
    junk = draw.draw(st.sampled_from([prefix, frame[:4] + prefix,
                                      frame[:8] + prefix + frame[8:]]))
    try:
        zstd.decompress(junk, cap=1 << 20)
    except ValueError:
        pass


@pytest.mark.parametrize("data,crc", [
    (b"", 0x00000000),
    (b"a", 0xC1D04330),
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_vectors(data, crc):
    assert zstd.crc32c(data) == crc


def test_crc32c_long_and_unaligned():
    data = RNG.integers(0, 256, 100_003, dtype=np.uint8).tobytes()
    whole = zstd.crc32c(data)
    assert zstd.crc32c(memoryview(data)[1:]) != whole
    # a bitwise reference on a slice
    def bitwise(buf):
        crc = 0xFFFFFFFF
        for byte in buf:
            crc ^= byte
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        return crc ^ 0xFFFFFFFF
    assert zstd.crc32c(data[:4099]) == bitwise(data[:4099])


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "zstd_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "_SRC", bad)
    monkeypatch.setattr(zstd, "_BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        zstd.build()
    assert not list((tmp_path / "_build").rglob("*.so"))
