"""A run with the timed path broken underneath comes out not correct: a
chunk whose merge leaves the node table as it was, half of each chunk's
reads left out, a GFA line altered where the writer makes it, a
.sequences record altered where the writer makes it, and half of the
records left out by the writer.  (A cell of one card
has no exchange between cards to leave out.)  The look for a card is
skipped; everything else is a run of the harness."""

import numpy as np
import pytest
import torch

from e2e_bench.tests.tiny import make_root, run_cell

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


def merge_nothing(monkeypatch):
    from rust_mdbg_tpu_torch.core.nodetable import NodeTable

    def merge_chunk(self, key_lo, key_hi, count):
        n = len(key_lo)
        return (np.zeros(n, dtype=np.uint8),
                np.full(n, 0xFFFFFFFF, dtype=np.uint32))

    monkeypatch.setattr(NodeTable, "merge_chunk", merge_chunk)


def half_of_each_chunk(monkeypatch):
    from rust_mdbg_tpu_torch.core import fastx_feed

    stream = fastx_feed.stream_chunks

    def stream_chunks(*a, **kw):
        for codes, lens, blob, off, fill in stream(*a, **kw):
            keep = max(1, fill // 2)
            lens = lens.copy()
            lens[keep:] = 0
            yield codes, lens, blob, off, keep

    monkeypatch.setattr(fastx_feed, "stream_chunks", stream_chunks)


def gfa_line_altered(monkeypatch):
    from rust_mdbg_tpu_torch.core.graph import IncrementalGFA

    finish = IncrementalGFA.finish_pot

    def finish_pot(self, path, *a, **kw):
        out = finish(self, path, *a, **kw)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace("KC:i:", "KC:i:1", 1))
        return out

    monkeypatch.setattr(IncrementalGFA, "finish_pot", finish_pot)


def record_altered(monkeypatch):
    from rust_mdbg_tpu_torch.core import chunked

    write = chunked.write_records_native

    def write_records_native(path, k, l, index, vecs, blob, start, end, rev,
                             shift0, shift1, **kw):
        return write(path, k, l, index, vecs, blob, start, end, rev,
                     shift0 + 1, shift1, **kw)

    monkeypatch.setattr(chunked, "write_records_native",
                        write_records_native)


def half_of_the_records(monkeypatch):
    from rust_mdbg_tpu_torch.core import chunked

    write = chunked.write_records_native

    def write_records_native(path, k, l, index, vecs, blob, *rows, **kw):
        every = [None if a is None else a[::2] for a in rows]
        if kw.get("mpos") is not None:
            kw["mpos"] = kw["mpos"][::2]
        return write(path, k, l, index[::2],
                     None if vecs is None else vecs[::2], blob, *every, **kw)

    monkeypatch.setattr(chunked, "write_records_native",
                        write_records_native)


@pytest.mark.parametrize("fault,number", [
    (merge_nothing, "gfa_lines_differ"),
    (half_of_each_chunk, "gfa_lines_differ"),
    (gfa_line_altered, "gfa_lines_differ"),
    (record_altered, "records_differ"),
    (half_of_the_records, "record_ids_differ")])
def test_fault_is_not_correct(root, monkeypatch, fault, number):
    fault(monkeypatch)
    rc, res = run_cell(root, "hg002-k21.tiny")
    assert rc == 0 and res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
