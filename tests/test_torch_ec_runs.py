"""Port parity: whole error-correction runs against the JAX package.

`--error-correct` through the port's streaming engine (the extraction on
the DeviceExtractor, here with CPU tensors) must write the JAX package's
bytes: `.ec_data`, `.postcor.ec_data`, `.poa.ec_data`, `.gfa` and the
`.sequences` shards, for the sequential driver with triage on and off,
the lockstep driver, forked workers (1 and 2), a correction threshold and
the host engine of the port.  The JAX package runs its host engine (its
device engine refuses EC).  The corpora are the noisy reads of
tests/test_ec_procs.py and tests/test_poa.py, and a deeper one where
templates recruit many candidates.  The other entry points are in
tests/test_torch_ec_cli.py.
"""

import numpy as np
import pytest
import torch

from rust_mdbg_tpu.core.pipeline import assemble as jax_assemble
from rust_mdbg_tpu.params import Params as JaxParams
from rust_mdbg_tpu_torch.core.pipeline import assemble
from rust_mdbg_tpu_torch.params import Params

from torch_corpus import EC_FILES, ec_outputs, ec_params, write_noisy_reads

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("ec_corpora")
    return {
        # tests/test_ec_procs.py (seeds 5, 7, 11) and tests/test_poa.py
        "procs5": write_noisy_reads(d / "p5.fa", 5, 50, 16000, 2500, 25),
        "procs7": write_noisy_reads(d / "p7.fa", 7, 50, 16000, 2500, 25),
        "procs11": write_noisy_reads(d / "p11.fa", 11, 50, 16000, 2500, 25),
        "poa": write_noisy_reads(d / "poa.fa", 5, 60, 20000, 3000, 30),
        # 20x over 4 kb at 0.15 % errors: templates recruit many candidates
        "deep": write_noisy_reads(d / "deep.fa", 9, 40, 4000, 2000, 3),
    }


#: (corpus, Params fields, ec_fast_triage)
CASES = {
    "seq_triage": ("procs5", {}, True),
    "seq_no_triage": ("procs5", {}, False),
    "lockstep": ("procs5", dict(ec_device_poa=True, ec_chunk=8), True),
    "procs1_threshold": ("procs11", dict(ec_procs=1,
                                         correction_threshold=2), True),
    "procs2": ("procs5", dict(ec_procs=2), True),
    "procs2_threshold": ("procs7", dict(ec_procs=2,
                                        correction_threshold=2), True),
    "seq_threshold": ("procs7", dict(correction_threshold=2), True),
    "poa_corpus": ("poa", {}, True),
    "deep_triage": ("deep", {}, True),
    "deep_no_triage": ("deep", {}, False),
    "deep_lockstep": ("deep", dict(ec_device_poa=True, ec_chunk=8), True),
    "deep_host_engine": ("deep", dict(engine="host"), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ec_run_matches_jax(tmp_path, corpora, case):
    corpus, fields, triage = CASES[case]
    reads = corpora[corpus]
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_fields = {k: v for k, v in fields.items() if k != "engine"}
    sj = jax_assemble(reads, ec_params(JaxParams, jax_fields, triage, "host"),
                      pj)
    st = assemble(reads, ec_params(Params, fields, triage, "device"), pt,
                  device="cpu")
    want, got = ec_outputs(pj), ec_outputs(pt)
    assert set(got) == set(want) >= set(EC_FILES) | {".gfa", ".0.sequences"}
    for ext in want:
        assert got[ext] == want[ext], ext
    assert st["nb_nodes"] == sj["nb_nodes"] > 0
    assert {"error-correct", "reingest"} <= set(st["phases"])
    if corpus == "deep":
        # the deep corpus really exercises recruitment and the weave
        lines = want[".poa.ec_data"].decode().splitlines()
        assert np.mean([len(x.split("\t")) - 1 for x in lines]) >= 5
