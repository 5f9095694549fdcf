"""Model configurations, copied from ``repro.configs``: shape data only (no
weights), so ``--arch`` offers the reference's choices.  ``shapes.py`` (the
dry-run's input shapes) is not copied yet."""
