"""AdamW, learning-rate schedules and gradient compression."""
