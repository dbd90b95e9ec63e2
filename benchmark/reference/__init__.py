"""The plain references of the benchmark's configurations: ``quad`` holds
the model, each controller's module its control step. A configuration
file names its module under ``reference``."""
