"""The training data pipeline (the Emit stage of a training deployment)."""
