"""The pipeline stages: dataset, tracker training, recording, and the CLI."""
