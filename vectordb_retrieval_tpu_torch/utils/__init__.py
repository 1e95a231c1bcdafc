"""Host-side helpers: device resolution, hashing."""
