"""Training: ``optimizer`` (AdamW, the schedule, global-norm clipping),
``checkpoint`` (atomic, GC'd save / restore) and ``trainer`` (the
fault-tolerant loop with Algorithm 1's batch shares)."""
