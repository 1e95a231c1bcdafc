"""Host-side helpers: device resolution, hashing, timing, counted work and
tracing, vector helpers."""
