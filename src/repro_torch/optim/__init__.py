"""AdamW with schedules and master weights."""
