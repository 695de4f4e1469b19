"""One module a traffic driver, named by a traffic file's "driver":
`run(cell, t0)` runs a cell once, `readings(cell, seeds, variants)` gives
the numbers its limits are set from."""
