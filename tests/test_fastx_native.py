"""Native C++ FASTX parser vs the pure-Python oracle (io/fastx.py).

The native parser (native/fastx.cpp) must deliver byte-identical sequences,
ids, lengths and codes for every input shape the Python reader handles:
plain/.gz, FASTA with multi-line records and CRLF, FASTQ, and over-long
reads returned as singleton chunks (same contract as fastx.batches).
"""

import gzip
import os
import random

import numpy as np
import pytest

from rust_mdbg_tpu.io import fastx
from rust_mdbg_tpu.io.fastx_native import NativeReader, chunks_prefetched
from rust_mdbg_tpu.utils.seq import BASE_CODE


def _random_fasta(path, n=57, minlen=20, maxlen=900, line_wrap=None,
                  crlf=False, gz=False, seed=0):
    rng = random.Random(seed)
    recs = []
    eol = b"\r\n" if crlf else b"\n"
    out = bytearray()
    for i in range(n):
        ln = rng.randint(minlen, maxlen)
        seq = bytes(rng.choice(b"ACGTNacgtn") for _ in range(ln))
        recs.append((f"read_{i}", seq))
        out += b">read_%d some description here" % i + eol
        if line_wrap:
            for j in range(0, ln, line_wrap):
                out += seq[j : j + line_wrap] + eol
        else:
            out += seq + eol
    data = bytes(out)
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return recs


def _random_fastq(path, n=33, minlen=10, maxlen=400, gz=False, seed=1):
    rng = random.Random(seed)
    recs = []
    out = bytearray()
    for i in range(n):
        ln = rng.randint(minlen, maxlen)
        seq = bytes(rng.choice(b"ACGT") for _ in range(ln))
        recs.append((f"q{i}", seq))
        out += b"@q%d extra" % i + b"\n" + seq + b"\n+\n" + b"I" * ln + b"\n"
    data = bytes(out)
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return recs


def _drain(path, chunk_reads, max_len):
    got = []
    rdr = NativeReader(path, chunk_reads, max_len)
    for c in rdr:
        for i in range(c.n):
            s = bytes(c.raw[c.raw_off[i] : c.raw_off[i + 1]])
            ln = int(c.lengths[i])
            assert ln == len(s)
            np.testing.assert_array_equal(
                c.codes[i, :ln],
                BASE_CODE[np.frombuffer(s, dtype=np.uint8)])
            got.append((c.id_str(i), s))
    rdr.close()
    return got


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("wrap,crlf", [(None, False), (60, False), (73, True)])
def test_fasta_parity(tmp_path, gz, wrap, crlf):
    p = str(tmp_path / ("r.fa" + (".gz" if gz else "")))
    recs = _random_fasta(p, line_wrap=wrap, crlf=crlf, gz=gz)
    assert _drain(p, chunk_reads=16, max_len=1024) == recs
    assert list(fastx.read_records(p)) == recs


@pytest.mark.parametrize("gz", [False, True])
def test_fastq_parity(tmp_path, gz):
    p = str(tmp_path / ("r.fq" + (".gz" if gz else "")))
    recs = _random_fastq(p, gz=gz)
    assert _drain(p, chunk_reads=7, max_len=512) == recs
    assert list(fastx.read_records(p)) == recs


@pytest.mark.parametrize("gz", [False, True])
def test_long_read_singleton(tmp_path, gz):
    """Reads past max_len come back as singleton chunks with widened codes."""
    p = str(tmp_path / ("r.fa" + (".gz" if gz else "")))
    recs = _random_fasta(p, n=9, minlen=30, maxlen=80, gz=gz, seed=3)
    # splice an over-long read into the middle of the file
    long_seq = bytes(random.Random(9).choice(b"ACGT") for _ in range(777))
    data = (gzip.open(p, "rb") if gz else open(p, "rb")).read()
    lines = data.split(b"\n")
    ins = b">big one\n" + long_seq + b"\n"
    data = b"\n".join(lines[:8]) + b"\n" + ins + b"\n".join(lines[8:])
    if gz:
        with gzip.open(p, "wb") as f:
            f.write(data)
    else:
        with open(p, "wb") as f:
            f.write(data)
    max_len = 256
    chunks = list(chunks_prefetched(p, 4, max_len))
    flat = []
    widths = []
    for c in chunks:
        widths.append(c.codes.shape[1])
        for i in range(c.n):
            flat.append((c.id_str(i),
                         bytes(c.raw[c.raw_off[i] : c.raw_off[i + 1]])))
    assert flat == list(fastx.read_records(p))
    big = [w for w in widths if w > max_len]
    assert big == [1024]  # 777 rounded up to a multiple of 256


def test_gz_window_growth(tmp_path):
    """A gz record larger than the initial window must still parse (window
    doubling in gz_refill)."""
    p = str(tmp_path / "r.fa.gz")
    seq = bytes(random.Random(4).choice(b"ACGT") for _ in range(100_000))
    with gzip.open(p, "wb") as f:
        f.write(b">huge\n")
        for j in range(0, len(seq), 80):
            f.write(seq[j : j + 80] + b"\n")
        f.write(b">tail\nACGTACGT\n")
    got = _drain(p, chunk_reads=4, max_len=200_000)
    assert got == [("huge", seq), ("tail", b"ACGTACGT")]


def test_raw_cap_short_chunks(tmp_path):
    """When the raw blob cap overflows, the parser returns short chunks and
    resumes cleanly."""
    p = str(tmp_path / "r.fa")
    recs = _random_fasta(p, n=40, minlen=500, maxlen=800, seed=5)
    rdr = NativeReader(p, chunk_reads=40, max_len=1024, mean_len_hint=0)
    rdr._raw_cap = 4096  # force overflow: ~6 reads per chunk
    got = []
    sizes = []
    for c in rdr:
        sizes.append(c.n)
        for i in range(c.n):
            got.append((c.id_str(i),
                        bytes(c.raw[c.raw_off[i] : c.raw_off[i + 1]])))
    rdr.close()
    assert got == recs
    assert len(sizes) > 1


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        NativeReader("/nonexistent/file.fa", 4, 128)


def test_pack_roundtrip():
    """2-bit pack/unpack roundtrip incl. N and pad codes (ops/pack)."""
    import numpy as np

    from rust_mdbg_tpu.ops.pack import pack_codes_np, unpack_codes_jax

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 6, (7, 64)).astype(np.uint8)  # 0..3, N=4, pad=5
    packed, mask = pack_codes_np(codes)
    assert packed.shape == (7, 16) and mask.shape == (7, 8)
    out = np.asarray(unpack_codes_jax(packed, mask))
    # N (4) and pad (5) round-trip DISTINCTLY: N is a real base to the HPC
    # rule (read.rs:163 compresses N runs), so collapsing it into pad would
    # shift minimizer positions on reads with NN runs
    assert np.array_equal(out, codes)


# --- the port's packed mode (rust_mdbg_tpu_torch/native/fastx.cpp) ----------

#: every byte class the planes tell apart: bases in both cases, N in both
#: cases, and IUPAC letters (invalid, not N)
_ALPHABET = b"ACGTACGTACGTacgtNnRYKMSWBDHVrykm"


def _packed_fasta(path, lengths, wrap=None, crlf=False, gz=False, seed=7):
    """A FASTA of reads of the given lengths over _ALPHABET, each with an N
    run; returns the path."""
    rng = random.Random(seed)
    eol = b"\r\n" if crlf else b"\n"
    out = bytearray()
    for i, ln in enumerate(lengths):
        seq = bytearray(rng.choice(_ALPHABET) for _ in range(ln))
        if ln > 10:
            j = rng.randrange(ln - 6)
            seq[j : j + 4] = b"NNNN"
        out += b">r%d desc" % i + eol
        step = wrap or max(1, ln)
        for j in range(0, ln, step):
            out += bytes(seq[j : j + step]) + eol
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(bytes(out))
    return path


def _lengths(n, lo, hi, seed=0, at=None):
    rng = random.Random(seed)
    ls = [rng.randint(lo, hi) for _ in range(n)]
    for i, ln in (at or {}).items():
        ls[i] = ln
    return ls


#: name -> (read lengths, L, L_half, writer options, raw_cap); chunks of 16
#: reads, so the 57th read ends a last partial chunk
_PACKED_CASES = {
    # every read fits the half width, one exactly at it
    "half": (_lengths(57, 1, 512, at={20: 512}), 1024, 512, {}, None),
    # one read past the half width: its chunk (the second) at full width
    "half_plus_one": (_lengths(57, 1, 512, at={20: 513, 40: 512}), 1024, 512,
                      {}, None),
    "no_half": (_lengths(57, 1, 1024, at={3: 1024}), 1024, 0, {}, None),
    "wrapped_crlf": (_lengths(57, 1, 1024, seed=1), 1024, 512,
                     dict(wrap=61, crlf=True), None),
    "gz": (_lengths(57, 1, 700, seed=2), 1024, 512, dict(gz=True, wrap=80),
           None),
    # the raw blob cap cuts each chunk short
    "raw_cap": (_lengths(57, 200, 900, seed=3), 1024, 512, {}, 3000),
}


def _plane_readers(path, L, half, raw_cap):
    from rust_mdbg_tpu_torch.io.fastx_native import NativeReader as TNR

    codes = TNR(path, 16, L)
    planes = TNR(path, 16, L, packed_half=half)
    if raw_cap:
        codes._raw_cap = planes._raw_cap = raw_cap
    return codes, planes


@pytest.mark.parametrize("case", list(_PACKED_CASES))
def test_parser_planes_equal_host_feed(tmp_path, case):
    """fx_next_packed's planes are host_feed's of fx_next's codes for the
    same chunk, byte for byte, at the width host_feed cuts to; the records,
    lengths, blob and ids are fx_next's."""
    from rust_mdbg_tpu_torch.core.chunked import host_feed

    lengths, L, half, opts, raw_cap = _PACKED_CASES[case]
    path = _packed_fasta(str(tmp_path / ("r.fa" + (".gz" if opts.get("gz")
                                                   else ""))),
                         lengths, **opts)
    plan = dict(L=L, L_half=half, packed=True)
    a, b = _plane_readers(path, L, half, raw_cap)
    widths, sizes = [], []
    while True:
        ca, cb = a.next_chunk(), b.next_chunk()
        assert (ca is None) == (cb is None)
        if ca is None:
            break
        assert cb.codes is None and ca.planes is None
        assert cb.n == ca.n and cb.start_index == ca.start_index
        for x, y in [(ca.lengths, cb.lengths), (ca.raw, cb.raw),
                     (ca.raw_off, cb.raw_off), (ca.ids, cb.ids),
                     (ca.ids_off, cb.ids_off)]:
            np.testing.assert_array_equal(x, y)
        want = host_feed(ca.codes, ca.lengths, ca.n, plan)
        assert [p.shape for p in cb.planes] == [w.shape for w in want]
        for got, ref in zip(cb.planes, want):
            assert got.dtype == np.uint8 and got.flags.c_contiguous
            assert got.tobytes() == ref.tobytes()
        widths.append(cb.planes[0].shape[1] * 4)
        sizes.append(ca.n)
    a.close()
    b.close()
    assert sum(sizes) == len(lengths)
    if raw_cap:
        assert max(sizes) < 16
    elif not opts.get("gz"):  # a .gz chunk also ends where its window does
        assert sizes[-1] == 57 % 16
    expect = {"half": {512}, "half_plus_one": {512, 1024},
              "no_half": {1024}}.get(case)
    if expect:
        assert set(widths) == expect
    if case == "half_plus_one":
        assert widths[1] == 1024


def test_packed_mode_hands_an_over_long_read_as_codes(tmp_path):
    """In packed mode a read past max_len still comes alone, as codes."""
    from rust_mdbg_tpu_torch.io.fastx_native import NativeReader as TNR

    path = _packed_fasta(str(tmp_path / "r.fa"),
                         _lengths(20, 1, 256, at={9: 777}))
    chunks = list(TNR(path, 8, 256, packed_half=128))
    assert [c.n for c in chunks] == [8, 1, 1, 8, 2]
    assert [c.planes is None for c in chunks] == [False, False, True,
                                                  False, False]
    assert chunks[2].codes.shape == (1, 1024) and chunks[2].lengths[0] == 777


def test_packed_mode_needs_widths_of_whole_bytes(tmp_path):
    from rust_mdbg_tpu_torch.io.fastx_native import NativeReader as TNR

    path = _packed_fasta(str(tmp_path / "r.fa"), [10])
    with pytest.raises(ValueError, match="divisible by 8"):
        TNR(path, 4, 1020, packed_half=0)


@pytest.fixture(scope="module")
def route_corpora(tmp_path_factory):
    """The port's raw test reads (400, 1.5 kb at most), the same with an
    over-long read (4.5 kb) at the 150th, and the first as .lz4."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_corpus import write_raw_reads
    from rust_mdbg_tpu_torch.io.lz4f import compress

    d = tmp_path_factory.mktemp("routes")
    raw = write_raw_reads(str(d / "raw.fa"))
    with open(raw) as f:
        text = f.read()
    lines = text.split("\n")
    full = [x for x in lines[1::2] if len(x) == 1500]
    lines[2 * 149 + 1] = "".join(full[:3])
    long = str(d / "long.fa")
    with open(long, "w") as f:
        f.write("\n".join(lines))
    lz4 = str(d / "raw.fa.lz4")
    with open(lz4, "wb") as f:
        f.write(compress(text.encode()))
    return dict(raw=raw, long=long, lz4=lz4)


@pytest.mark.parametrize("kind,parser,host", [
    ("raw", 7, 0), ("long", 7, 1), ("lz4", 0, 7)])
def test_feed_counts_its_packing_route(tmp_path, route_corpora, kind, parser,
                                       host):
    """The chunked driver's counters say which route packed each chunk:
    the parser for the native reader's chunks, host_feed for an over-long
    read's singleton chunk and for every chunk of the Python fallback."""
    import torch

    from rust_mdbg_tpu_torch.core.chunked import assemble_device_chunked
    from rust_mdbg_tpu_torch.params import Params as TParams

    torch.set_num_threads(2)
    st = assemble_device_chunked(
        route_corpora[kind], TParams(k=7, l=12, density=0.01,
                                     min_kmer_abundance=2),
        str(tmp_path / "out"), chunk_reads=64, device="cpu")
    c = st["counters"]
    assert st["nb_chunks"] == parser + host
    assert c["feed.parser_packed_chunks"] == parser
    assert c["feed.host_packed_chunks"] == host
    assert 1 <= c["feed.staged_high"] <= 2
