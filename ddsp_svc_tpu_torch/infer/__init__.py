"""The enhancer front end, the offline segment loop, run_inference and
the CLI."""
