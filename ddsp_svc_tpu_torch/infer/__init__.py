"""The enhancer front end and the offline segment loop."""
