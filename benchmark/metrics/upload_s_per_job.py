"""Index upload seconds a job: the window's jobs' summed
`stage_seconds.upload` (every group's planes to the card) over the jobs."""


def read(record):
    if record.get("entry") != "workflow" or not record.get("jobs"):
        return None
    up = record.get("upload_seconds")
    return None if up is None else up / record["jobs"]
