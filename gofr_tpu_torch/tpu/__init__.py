"""Device-side serving runtime: device resolution, sampling, engines."""
