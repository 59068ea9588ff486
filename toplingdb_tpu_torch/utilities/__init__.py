"""The utilities: transactions, write batches with an index, checkpoints,
backups, SST ingestion, TTL and option migration."""
