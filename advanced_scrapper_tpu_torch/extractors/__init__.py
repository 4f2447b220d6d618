"""The streaming batch backend behind the extractor plugin boundary."""
