"""The recommender family: DeepFM (the port of the reference's
``models/recsys/``)."""
