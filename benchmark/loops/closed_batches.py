"""The CLI's ``-mode 1`` loop, closed: batch after batch, ``search()``
then ``emit``; a batch starts when the one before it has been written.
The window ends with the first batch that ends after its seconds."""


def window(session):
    while True:
        key, records = session.take()
        with session.batch(key):
            session.emit(key, session.search(records))
        if session.over():
            return
