"""One module a configuration family: `build(cfg, traffic, seed, device,
gen)` returns the cell the harness drives (request, counters, work, close,
check)."""
