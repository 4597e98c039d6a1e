"""The port's zstd decoder and CRC-32C (``umetrack_torch/utils/_zstd.py`` over
``csrc/zstd_decode.cpp``) held against the ``zstandard`` package on the
CPU: every frame ``zstandard`` writes for the inputs below (levels -5 to
19, with and without a checksum, with and without a content size) decodes
to the same bytes, a hypothesis fuzz over sizes and levels, concatenated
and skippable frames, and corrupt input raising instead of crashing."""
import os
import struct

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from umetrack_torch.utils import _zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 9, 19)


def _inputs():
    rng = np.random.default_rng(0)
    with open(os.path.join(REPO, "checkpoints", "synthetic.msgpack"), "rb") as fp:
        weights = fp.read()[:1 << 20]
    with open(os.path.join(REPO, "README.md"), "rb") as fp:
        text = fp.read()
    runs = b"".join(bytes([int(rng.integers(0, 4))]) * int(rng.integers(1, 3000)) for _ in range(200))
    # geometric symbol frequencies: Huffman weights written directly, not FSE-coded
    p = 0.5 ** np.arange(1, 61)
    geometric = rng.choice(np.arange(60, dtype=np.uint8), 3000, p=p / p.sum()).tobytes()
    # a random block, then one literal "z" before each match into it: at
    # level 19 the second block's literals are one byte repeated (RLE)
    block = rng.bytes(128 << 10)
    z_literals = block + b"".join(b"z" + block[s:s + 60] for s in rng.permutation(2000)[:400] * 64)
    return {
        "empty": b"", "one_byte": b"\x07", "rle_runs": runs, "random": rng.bytes(200_000),
        "weights_1mb": weights, "text": text, "geometric": geometric, "z_literals": z_literals,
    }


INPUTS = _inputs()


def _frames(data, level):
    """(name, frame) for each of zstandard's writers at ``level``."""
    out = []
    for checksum in (False, True):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
        out.append((f"checksum={checksum},content_size=True", c.compress(data)))
        stream = c.compressobj()  # the streaming writer knows no content size
        out.append((f"checksum={checksum},content_size=False", stream.compress(data) + stream.flush()))
    return out


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_what_zstandard_writes(name, level):
    data = INPUTS[name]
    for variant, frame in _frames(data, level):
        assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
        assert _zstd.decompress(frame) == data, variant


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["text"], INPUTS["rle_runs"]
    first = zstandard.ZstdCompressor(level=3).compress(a)
    second = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b)
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    assert _zstd.decompress(first + second) == a + b
    assert _zstd.decompress(skippable + first + skippable + second) == a + b


_pieces = st.one_of(
    st.binary(min_size=1, max_size=64),
    st.tuples(st.binary(min_size=1, max_size=8), st.integers(1, 400)).map(lambda t: t[0] * t[1]),
)


@settings(max_examples=80, deadline=None)
@given(parts=st.lists(_pieces, max_size=60), level=st.sampled_from(LEVELS + (22,)),
       checksum=st.booleans())
def test_fuzz_sizes_and_levels(parts, level, checksum):
    data = b"".join(parts)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert _zstd.decompress(frame) == data


def test_corrupt_checksum_and_truncation_raise():
    data = INPUTS["text"]
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0xFF
    with pytest.raises(_zstd.ZstdError, match="checksum"):
        _zstd.decompress(bytes(frame))
    frame[-1] ^= 0xFF
    for cut in (0, 3, 5, len(frame) // 2, len(frame) - 1):
        with pytest.raises(_zstd.ZstdError):
            _zstd.decompress(bytes(frame[:cut]))
    with pytest.raises(_zstd.ZstdError, match="magic"):
        _zstd.decompress(b"not a zstd frame")


def test_random_damage_raises_or_decodes_never_crashes():
    rng = np.random.default_rng(1)
    frames = [zstandard.ZstdCompressor(level=lv, write_checksum=True).compress(INPUTS[n][:50_000])
              for lv in (1, 19) for n in ("text", "weights_1mb", "rle_runs")]
    for i in range(300):
        frame = bytearray(frames[i % len(frames)])
        for _ in range(int(rng.integers(1, 4))):
            frame[int(rng.integers(0, len(frame)))] ^= int(rng.integers(1, 256))
        try:
            _zstd.decompress(bytes(frame))
        except _zstd.ZstdError:
            pass


def test_a_dictionary_frame_is_refused():
    # magic, single segment with a 1-byte dictionary id (42) and content
    # size (0), one empty raw block
    frame = _zstd.MAGIC + bytes([0x21, 42, 0]) + bytes([0x01, 0, 0])
    with pytest.raises(_zstd.ZstdError, match="dictionary 42"):
        _zstd.decompress(frame)
    assert _zstd.decompress(_zstd.MAGIC + bytes([0x20, 0]) + bytes([0x01, 0, 0])) == b""


def test_xxh64_is_zstd_content_checksum():
    rng = np.random.default_rng(2)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = rng.bytes(n)
        frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)
        assert _zstd.xxh64(data) & 0xFFFFFFFF == struct.unpack("<I", frame[-4:])[0], n


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, (128 << 10) + 1, 300_000])
def test_stored_frames_decode_in_both(size):
    data = np.random.default_rng(size).bytes(size)
    frame = _zstd.frame_stored(data)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
    assert _zstd.decompress(frame) == data


def test_crc32c_check_value_and_orbax_footers(tmp_path):
    from umetrack_tpu.utils.checkpoints import save_checkpoint as jsave

    assert _zstd.crc32c(b"123456789") == 0xE3069283
    assert _zstd.crc32c(b"6789", _zstd.crc32c(b"12345")) == 0xE3069283
    jsave(str(tmp_path / "ckpt"), {"params": {"w": np.arange(6, dtype=np.float32)}})
    checked = 0
    for folder, _, files in os.walk(tmp_path / "ckpt"):
        for name in files:
            with open(os.path.join(folder, name), "rb") as fp:
                data = fp.read()
            if data[:2] == b"\x0c\xdb":  # a manifest or B+tree node file
                assert _zstd.crc32c(data[:-4]) == struct.unpack("<I", data[-4:])[0], name
                checked += 1
    assert checked >= 2
