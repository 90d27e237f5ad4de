"""One module per kind of window; a cell's traffic file names its runner.

Each module has a `Runner(config, traffic, seed, device, control=False,
wrap=None)` with `setup()`, `window(seconds, probe) -> record`,
`release()` and `check() -> {name: (value, limit)}`. `control` runs the
program's one-verdict-per-batch path in place of the exact one (the
control that the output check has to fail); `wrap(backend)` lets a test
plant a fault under the timed path.
"""
