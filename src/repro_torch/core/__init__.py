"""Core of the port: device and resource models, the kernel design space,
the cost DB and caches, the surrogate and the kernel evaluator."""
