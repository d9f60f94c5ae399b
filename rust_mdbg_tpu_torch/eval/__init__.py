"""Evaluation tools the port carries: `retrace_minimizers`, which
`extreme-simplify` calls; the error-correction metrics `evaluate_ec`
(`blast_identity`, which `ec-scale` reports), `evaluate_poa` and
`ref_assisted_ec`; and the k-min-mer metrics `compare_kmers`,
`mappability` and `recovery_grid` (which assembles on the card)."""
