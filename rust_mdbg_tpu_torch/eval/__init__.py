"""Evaluation tools the port carries: `retrace_minimizers`, which
`extreme-simplify` calls."""
