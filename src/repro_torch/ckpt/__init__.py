"""Checkpoints: atomic keep-N saves of tensor trees, readable by either
package (`checkpoint.py`)."""
