"""JAX-free twins of the reference's dataset tools (tools/evaluate.py, tools/view.py)."""
