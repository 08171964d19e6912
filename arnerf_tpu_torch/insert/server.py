"""Length-prefixed TCP transport for the external OpenGL viewer (port of
arnerf_tpu/insert/server.py; reference insert/server.py): an 8-byte
little-endian length header in both directions, the port auto-incremented
on bind conflicts."""

import socket


class Server:
    def __init__(self, ip="127.0.0.1", port=5001, automatic_port=True):
        self.s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if automatic_port:
            attempts = 5
            while attempts > 0:
                try:
                    self.s.bind((ip, port))
                    break
                except OSError:
                    print(f"[Server]: Port {port} already in use. "
                          f"Binding to port: {port + 1}")
                    port += 1
                    attempts -= 1
            else:
                print("[Server]: Error binding to address!")
        else:
            self.s.bind((ip, port))
        self.port = port
        self.s.listen(True)
        print("[Server]: Waiting for connection...")
        self.conn, _ = self.s.accept()
        print("[Server]: Connected")

    def __del__(self):
        try:
            self.s.close()
        except Exception:
            pass

    def send(self, message):
        self.conn.sendall(len(message).to_bytes(8, "little"))
        self.conn.sendall(message)

    def receive(self):
        len_buf = self.conn.recv(8)
        if not len_buf:
            return b""
        length = int.from_bytes(len_buf, "little")
        buf = b""
        while length:
            newbuf = self.conn.recv(length)
            if not newbuf:
                print("Error: incomplete msg")
                break
            buf += newbuf
            length -= len(newbuf)
        return buf

    def clear_buffer(self):
        try:
            while self.conn.recv(1024):
                pass
        except Exception:
            pass
