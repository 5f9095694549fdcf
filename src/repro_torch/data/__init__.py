"""Input pipelines: ``pipeline`` (the deterministic synthetic LM stream)."""
