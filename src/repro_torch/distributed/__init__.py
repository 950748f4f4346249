"""SLOTH one level up: pod telemetry from per-step timings."""
