"""Device selection and operator knobs."""
