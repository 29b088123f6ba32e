"""Host-side helpers: device selection and atomic artifact writes."""
