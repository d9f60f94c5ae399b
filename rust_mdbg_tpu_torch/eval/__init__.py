"""Evaluation tools the port carries: `retrace_minimizers`, which
`extreme-simplify` calls, and the error-correction metrics `evaluate_ec`
(`blast_identity`, which `ec-scale` reports) and `evaluate_poa`."""
