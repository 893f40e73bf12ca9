"""Decoder-only LMs for serving: a port of `repro.models`."""
