"""Device selection, introspection and kernel timing."""
