"""The port's command-line programs, run as
`python -m instantvnr_torch.apps.<name>` (counterparts of `apps/`)."""
