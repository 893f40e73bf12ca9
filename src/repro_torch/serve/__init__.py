"""Serving engines: `engine.ServeEngine`, the LM token server."""
