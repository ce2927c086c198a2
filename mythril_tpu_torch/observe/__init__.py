"""The port's tracing surface: `trace` is a null tracer that records
nothing. The port's own span and metric registry replaces it (ROADMAP A
14)."""
