"""The training loop and its optimizer."""
