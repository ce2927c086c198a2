"""The port's observability surface: `trace` is a null tracer and
`metrics` a null registry; both record nothing. The port's own span and
metric registry replaces them (ROADMAP A 14)."""
