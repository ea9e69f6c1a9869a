"""Model configurations the port can train and prove (`registry`)."""
